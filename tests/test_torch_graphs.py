"""The port's compiled programs (`graphs.capture_graph` and its users) on
the CPU, where they run eagerly, and the train step's capture logic with a
stand-in for the CUDA graph:

- the lr is a float32 tensor on the parameters' device that the schedule
  fills with `lr_schedule(count)` at every count across two staircase
  boundaries, for Adam and momentum; the `lr` metric is the value from
  before the schedule steps;
- n calls of each step entry point (`make_train_step`,
  `make_train_step_on_batch`, the world-of-one step of
  `kungfu.make_kungfu_steps`) make n updates, eagerly and through the
  capture logic (CAPTURE_WARMUP eager steps, a capture that executes
  nothing, one replay a step, each step's batch copied into the static
  buffers), and give the eager run's parameters bit for bit;
- a resume equals an uninterrupted run, and drops the captured steps;
- the momentum step across a decay boundary equals the JAX step;
- a CPU engine's flip-TTA and scale search are the eager functions' calls
  (no graph), under the default, fidelity() and quality() decoders.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from openpose_plus_tpu import train as JT
from openpose_plus_tpu_torch import checkpoint as ckpt
from openpose_plus_tpu_torch import engine as tengine
from openpose_plus_tpu_torch import train as T
from openpose_plus_tpu_torch.engine import Engine
from openpose_plus_tpu_torch.graphs import CAPTURE_WARMUP
from openpose_plus_tpu_torch.parallel import kungfu

from tests.test_torch_train import (_as_torch, _batch, _configs,
                                    _port_state, _port_targets)
from tests.test_torch_tta import _engines as _tta_engines

torch.set_num_threads(2)

OPTIMIZERS = ["adam", "momentum"]
ENTRY_POINTS = ["make_train_step", "make_train_step_on_batch", "kungfu"]


def _cfg(optimizer, **train):
    """The tiny float32 VGG-tiny of tests/test_torch_train.py, decaying the
    lr every 3 steps."""
    _, cfg = _configs("vggtiny", optimizer=optimizer, lr_decay_every=3,
                      lr_decay_factor=0.5, weight_decay=5e-4, **train)
    return cfg


def _step_fn(cfg, entry):
    """step(state, i) -> (state, metrics) of one entry point on batch i."""
    if entry == "make_train_step":
        step = T.make_train_step(cfg)
        args = [_port_targets(cfg, _batch(cfg, seed=i)) for i in range(8)]
        return lambda state, i: step(state, *args[i])
    if entry == "make_train_step_on_batch":
        step = T.make_train_step_on_batch(cfg)
    else:
        (step,) = kungfu.make_kungfu_steps(cfg, None, "sync-sgd")
    return lambda state, i: step(state, _batch(cfg, seed=i))


def _optimizer_steps(state) -> set:
    """The update counts the optimizer keeps (Adam's per-parameter step;
    momentum keeps none)."""
    return {int(st["step"]) for st in state.optimizer.state.values()
            if "step" in st}


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_tensor_lr_follows_the_schedule(optimizer):
    """Every group's lr is one float32 tensor on the parameters' device for
    the whole run, filled with lr_schedule(count) rounded once to float32,
    across the boundaries at counts 3 and 6; the `lr` metric of the step
    at count c is lr_schedule(c), the value before the schedule steps."""
    cfg = _cfg(optimizer)
    schedule = T.lr_schedule(cfg.train)
    state = T.create_train_state(cfg, device="cpu")
    lrs = [g["lr"] for g in state.optimizer.param_groups]
    assert all(isinstance(lr, torch.Tensor) and lr.dtype == torch.float32
               and lr.device.type == "cpu" and lr.dim() == 0 for lr in lrs)
    step = _step_fn(cfg, "make_train_step")
    for count in range(8):
        want = np.float32(schedule(count))
        assert all(float(lr) == want for lr in lrs), count
        state, metrics = step(state, count)
        assert float(metrics["lr"]) == want
        assert metrics["lr"] is not lrs[0]
        assert all(g["lr"] is lr for g, lr in zip(
            state.optimizer.param_groups, lrs))
        assert all(float(lr) == np.float32(schedule(count + 1))
                   for lr in lrs)
    assert float(metrics["lr"]) == np.float32(cfg.train.lr_init * 0.25)


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_n_calls_make_n_updates(entry, optimizer):
    cfg = _cfg(optimizer)
    state = T.create_train_state(cfg, device="cpu")
    step = _step_fn(cfg, entry)
    for n in range(1, 6):
        state, _ = step(state, n)
        assert state.step == n and state.scheduler.last_epoch == n
        assert _optimizer_steps(state) <= {n}
    assert state.graphs == {}              # nothing is captured on the CPU
    if optimizer == "adam":
        assert _optimizer_steps(state) == {5}


class _FakeGraph:
    """Stands in for a CUDA graph on the CPU: replay() runs the captured
    step and writes its metrics into the graph's own outputs."""

    def __init__(self, step, out):
        self.step, self.out, self.replays = step, out, 0

    def replay(self):
        self.replays += 1
        for key, value in self.step().items():
            self.out[key].copy_(value)


@pytest.fixture
def fake_card(monkeypatch):
    """`train._graphed`'s card path on the CPU: a state whose device says
    "cuda", the batch left where it is, the side-stream warm-up run in
    place, and a capture that records the step without running it. Returns
    the list of (warm-ups, graph) captures made."""
    captures = []

    def capture_graph(step, device, warmup):
        out = {k: torch.zeros(()) for k in ("loss_conf_last",
                                            "loss_paf_last", "loss")}
        graph = _FakeGraph(step, out)
        captures.append((warmup, graph))
        return graph, out

    monkeypatch.setattr(T, "capture_graph", capture_graph)
    monkeypatch.setattr(T, "on_side_stream", lambda fn, device: fn())
    monkeypatch.setattr(T, "_to_device", lambda x, device: torch.as_tensor(x))
    return captures


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_graphed_steps_equal_eager_steps(entry, optimizer, fake_card):
    """Through the capture logic: CAPTURE_WARMUP eager steps, then one
    capture (which runs nothing) of the key and one replay a step, each on
    its own batch copied into the static buffers. The parameters, the
    optimizer's counts, every step's loss and lr equal an eager run's bit
    for bit: n calls are n updates."""
    cfg = _cfg(optimizer)
    eager = T.create_train_state(cfg, device="cpu")
    graphed = T.create_train_state(cfg, device="cpu")
    graphed.device = types.SimpleNamespace(type="cuda")
    step = _step_fn(cfg, entry)
    for n in range(1, 8):
        eager, m_eager = T._finish(
            eager, T._apply(eager, *_port_targets(cfg, _batch(cfg, seed=n))),
            T._lr_metric(eager))
        graphed, m = step(graphed, n)
        assert graphed.step == n and graphed.scheduler.last_epoch == n
        assert len(fake_card) == (n > CAPTURE_WARMUP)
        (entry_state,) = graphed.graphs.values()
        if n <= CAPTURE_WARMUP:
            assert entry_state == n
        else:
            assert entry_state.graph.replays == n - CAPTURE_WARMUP
        for key in ("loss", "loss_conf_last", "loss_paf_last", "lr"):
            assert torch.equal(m[key], m_eager[key]), (n, key)
    (warmup, graph), = fake_card
    assert warmup == 0
    assert _optimizer_steps(graphed) == _optimizer_steps(eager)
    for a, b in zip(graphed.model.state_dict().values(),
                    eager.model.state_dict().values()):
        assert torch.equal(a, b)
    # the metrics returned are copies: the next replay leaves them be
    held = m["loss"].clone()
    step(graphed, 1)
    assert torch.equal(m["loss"], held)


def test_graphed_steps_are_keyed_by_shape(fake_card):
    """Another batch shape warms up and captures on its own."""
    cfg = _cfg("adam")
    state = T.create_train_state(cfg, device="cpu")
    state.device = types.SimpleNamespace(type="cuda")
    step = T.make_train_step_on_batch(cfg)
    for i in range(CAPTURE_WARMUP + 2):
        for b in (2, 1):
            batch = _batch(cfg, seed=i)
            state, _ = step(state, {k: v[:b] for k, v in batch.items()})
    assert len(state.graphs) == 2 and len(fake_card) == 2
    assert state.step == 2 * (CAPTURE_WARMUP + 2)
    assert all(g.graph.replays == 2 for g in state.graphs.values())


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_resume_equals_an_uninterrupted_run(optimizer, tmp_path, fake_card):
    """6 steps in one run, and 3 steps, a checkpoint, a restore into a
    fresh state and 3 more, both through the capture logic: equal
    parameters, optimizer state, schedule and lr. The restore drops the
    captured step (its optimizer tensors are replaced), so the resumed run
    warms up and captures again."""
    cfg = _cfg(optimizer)
    step = T.make_train_step_on_batch(cfg)

    def fresh():
        state = T.create_train_state(cfg, device="cpu")
        state.device = types.SimpleNamespace(type="cuda")
        return state

    whole = fresh()
    for i in range(6):
        whole, _ = step(whole, _batch(cfg, seed=i))
    first = fresh()
    for i in range(3):
        first, _ = step(first, _batch(cfg, seed=i))
    assert len(first.graphs) == 1
    ckpt.save(str(tmp_path / "ck"), first, first.step)
    resumed = T.create_train_state(cfg, seed=7, device="cpu")
    resumed.graphs["stale"] = 1
    resumed = ckpt.restore(str(tmp_path / "ck"), resumed)
    assert resumed.graphs == {} and resumed.step == 3
    lrs = [g["lr"] for g in resumed.optimizer.param_groups]
    assert all(isinstance(lr, torch.Tensor) and lr.dtype == torch.float32
               for lr in lrs)
    resumed.device = types.SimpleNamespace(type="cuda")
    for i in range(3, 6):
        resumed, m = step(resumed, _batch(cfg, seed=i))
    # one capture each: the whole run, the first part, and the resumed run
    assert len(fake_card) == 3
    assert resumed.step == 6 and resumed.scheduler.last_epoch == 6
    for a, b in zip(resumed.model.state_dict().values(),
                    whole.model.state_dict().values()):
        assert torch.equal(a, b)
    for p, q in zip(resumed.model.parameters(), whole.model.parameters()):
        sa, sb = resumed.optimizer.state[p], whole.optimizer.state[q]
        assert sa.keys() == sb.keys()
        for key in sa:
            assert torch.equal(sa[key], sb[key]), key
    assert [float(g["lr"]) for g in resumed.optimizer.param_groups] == \
        [float(g["lr"]) for g in whole.optimizer.param_groups]


def test_resume_from_a_float_lr_checkpoint(tmp_path):
    """A checkpoint whose groups hold a Python float lr (as before the lr
    became a tensor) restores to a float32 tensor lr."""
    cfg = _cfg("adam")
    state = T.create_train_state(cfg, device="cpu")
    state, _ = T.make_train_step_on_batch(cfg)(state, _batch(cfg))
    saved = state.state_dict()
    for group in saved["optimizer"]["param_groups"]:
        group["lr"] = float(group["lr"])
    fresh = T.create_train_state(cfg, seed=5, device="cpu")
    fresh.load_state_dict(saved)
    for a, b in zip(fresh.optimizer.param_groups,
                    state.optimizer.param_groups):
        assert isinstance(a["lr"], torch.Tensor)
        assert a["lr"].dtype == torch.float32 and float(a["lr"]) == \
            float(b["lr"])
        assert a["capturable"] is False


def test_momentum_across_a_decay_boundary_matches_jax():
    """make_train_step_on_batch with momentum and the lr halved every 2
    steps, 5 steps: each step's lr within 1 float32 ulp of optax's and the
    parameters within float32 rounding (1e-6) of the JAX step's."""
    jcfg, cfg = _configs("vggtiny", optimizer="momentum", weight_decay=5e-4,
                         lr_init=1e-2, lr_decay_every=2, lr_decay_factor=0.5)
    jstate, state = _port_state(jcfg, cfg)
    jstep = JT.make_train_step_on_batch(jcfg)
    step = T.make_train_step_on_batch(cfg)
    for i in range(5):
        batch = _batch(cfg, seed=i)
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, batch)
        np.testing.assert_array_max_ulp(np.float32(m["lr"]),
                                        np.float32(jm["lr"]), 1)
    assert int(jstate.step) == state.step == 5
    ref, out = _as_torch(jax.device_get(jstate.params)), \
        state.model.state_dict()
    for name, r in ref.items():
        np.testing.assert_allclose(out[name].numpy(), r.numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)


# ---------------------------------------------------- flip-TTA, scales ---

_ENGINES = {}


def _engine(post: str) -> Engine:
    """tests/test_torch_tta.py's tiny float32 MobileNet-thin on the CPU
    (heads scaled so random images decode to humans), under the default,
    fidelity() or quality() decoder."""
    if post not in _ENGINES:
        base = _tta_engines()[1]
        cfg = base.config
        if post != "default":
            cfg = cfg.replace(postproc=getattr(cfg.postproc, post)())
        _ENGINES[post] = Engine(cfg, params=base.model.state_dict(),
                                device="cpu")
    return _ENGINES[post]


def _same(a, b) -> bool:
    return all(torch.equal(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a))


@pytest.mark.parametrize("post", ["default", "fidelity", "quality"])
@pytest.mark.parametrize("path", ["tta", "avg", "avg_flip", "dedup",
                                  "dedup_flip"])
def test_cpu_engine_accuracy_paths_stay_eager(path, post):
    """A CPU engine's flip-TTA and scale search equal the module functions'
    eager calls bit for bit, twice (nothing captured, nothing held)."""
    engine = _engine(post)
    images = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 64, 64, 3), dtype=np.uint8))
    cfg = engine.config
    scales = (0.5, 1.0, 1.5)
    with torch.inference_mode():
        if path == "tta":
            ref = tengine.infer_tta(engine.model, images, cfg.postproc)
        else:
            combine, _, flip = path.partition("_")
            fn = (tengine.infer_multiscale_avg if combine == "avg"
                  else tengine.infer_multiscale_dedup)
            ref = fn(engine.model, images, cfg.postproc, scales, bool(flip),
                     cfg.model.stride)
    for _ in range(2):
        if path == "tta":
            out = engine.infer(images, flip_tta=True)
        else:
            out = engine.infer_multiscale(images, scales, flip_tta=bool(flip),
                                          combine=combine)
        assert _same(out, ref)
    assert engine._accuracy_graphs == {} and engine._graphs == {}
    if path == "tta":
        assert int(ref.num_humans.sum()) >= 1


# ------------------------------------------------------ loaded artifacts ---

def test_int8_artifact_holds_the_packed_weights(tmp_path):
    """An int8 engine exports its packed int8 weights as the program's
    constants: the program never reads an int8 layer's float weight (no
    quantize-and-pack at every call), the engine's model is left as it
    was, and the CPU artifact serves the engine's HumanBatch eagerly."""
    from openpose_plus_tpu_torch import export
    from openpose_plus_tpu_torch.models.common import _Int8Layer

    cfg = _tta_engines()[1].config
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                compute_dtype="int8"))
    engine = Engine(cfg, seed=0, device="cpu")
    images = np.random.default_rng(2).integers(0, 256, (2, 64, 64, 3),
                                               dtype=np.uint8)
    engine.calibrate(images)
    keys = set(engine.model.state_dict())
    export.save_engine(engine, str(tmp_path / "q"), batch_size=2)
    assert set(engine.model.state_dict()) == keys
    assert not any("packed_weight" in name
                   for name, _ in engine.model.named_buffers())
    layers = {name: m for name, m in engine.model.named_modules()
              if isinstance(m, _Int8Layer) and m.int8}
    assert layers
    loaded = export.load_engine(str(tmp_path / "q"))
    program = loaded._program
    sig = program.graph_signature
    users = {n.name: len(n.users) for n in program.graph.nodes
             if n.op == "placeholder"}
    # the program's names are the engine step's: the model under "model."
    float_weights = {f"model.{name}.{m.int8_weight_name}"
                     for name, m in layers.items()}
    params = {fqn: users[ph] for ph, fqn in sig.inputs_to_parameters.items()}
    assert float_weights <= params.keys()
    assert [fqn for fqn in float_weights if params[fqn]] == []
    packed = {fqn for fqn in sig.inputs_to_buffers.values()
              if fqn.endswith(".packed_weight")}
    assert packed == {f"model.{name}.packed_weight" for name in layers}
    out = loaded.infer(images)
    assert loaded._graph is None           # a CPU artifact runs eagerly
    assert _same(out, engine.infer(images))


def test_artifact_constants_move_to_the_device(tmp_path):
    """The program keeps the decoder's numpy-made constants on the host and
    copies them over at every call, behind a check that they are on the
    host: a CUDA artifact moves them to the card once at load and drops
    those checks (a capture refuses a pageable copy). Here the move goes
    to the meta device, which the CPU can show: every constant moves, one
    check each goes, and the input's check stays."""
    from openpose_plus_tpu_torch import export

    export.save_engine(_engine("default"), str(tmp_path / "a"), batch_size=2)
    module = export.load_engine(str(tmp_path / "a"))._call
    check = torch.ops.aten._assert_tensor_metadata.default

    def constants(device_type):
        out = []
        for node in module.graph.nodes:
            if node.op == "get_attr":
                owner, _, name = node.target.rpartition(".")
                value = getattr(module.get_submodule(owner), name)
                if (not isinstance(value, torch.nn.Parameter)
                        and value.device.type == device_type):
                    out.append(node.target)
        return out

    def checks():
        return [n for n in module.graph.nodes if n.target is check]

    host = constants("cpu")
    n_checks = len(checks())
    assert host
    export._constants_to(module, torch.device("meta"))
    assert constants("cpu") == [] and sorted(constants("meta")) == \
        sorted(host)
    assert len(checks()) == n_checks - len(host)
    assert any(n.args[0].op == "placeholder" for n in checks())
