"""The spatial mesh axis of the port (`openpose_plus_tpu_torch.parallel.
spatial`: the image height sharded over ranks, halo-exchanged convs) against
the unsharded port and the JAX package (GSPMD's height sharding) on the CPU.

The port runs as gloo ranks in spawned processes (tests/torch_ranks.py),
float32, one spawn a world size (2 and 4 ranks, module-scoped fixtures);
the reference on a mesh of its virtual CPU devices. On the same seeded
numpy inputs and Flax parameters (`checkpoint.from_flax`):

- the band-aware conv and pool (`common.conv2d_same` / `maxpool2x2` under
  a band) for every kernel, stride and pool of the zoo (3x3 dense and
  depthwise at stride 1 and 2, 7x7, 1x1, the 2x2 pool) at every level of
  the stride-8 grid, on 2 ranks, on 4 with uneven bands (10 output rows)
  and with a 7x7 halo wider than a band: the output bands concatenated
  equal the unsharded output bit for bit, the input gradient bands and
  the summed weight gradients lie within 1e-5 of their scale (summation
  order; measured <= 2e-6); each exchange brings exactly the halo rows x
  width x channels x batch that the SAME conv's geometry says;
- each backbone's sharded forward (`spatial.band_forward`) on 2 and 4
  ranks, the last stage's maps within 1e-5 of their scale of the
  unsharded port's and of the JAX model's (measured <= 3.3e-6 and the
  zoo's float32 <= 4e-6), including MobileNet-thin and hao28 on 10 output
  rows over 4 ranks, VGG19 at 2 output rows a rank (its 7x7 refine convs
  read 3) and `remat_stages=True`; the parameter gradients of a fixed cotangent summed
  over the ranks within 1e-4 of each leaf's scale of the unsharded ones
  (measured <= 2.7e-6), the recomputed branches' exchanges included;
- sync-sgd on a 2 data x 2 spatial mesh (VGG-tiny, 64x64, 2 stages,
  momentum SGD at lr 1e-2, a global batch of 8, 2 steps) against the
  reference's `make_train_step_on_batch` on `build_mesh` of 2x2 virtual
  devices (tests/test_train.py's spatial case) under
  tests/test_torch_parallel.py's JAX_LOSS_RTOL / JAX_MOST_ATOL /
  JAX_ALL_ATOL, and against the port's one-process step under PARAM_ATOL
  / PARAM_MAX; the four replicas bit-identical; sma and pair-avg raise the
  reference's message on that mesh;
- `train_loop` on 2 spatial ranks: both ranks step on bands of one batch,
  the one-process run's, and rank 0's checkpoint equals that run's
  within PARAM_MAX;
- `Engine(mesh=)` on 1x2 and 2x2 meshes: every rank returns the whole
  HumanBatch, bit-equal to an unsharded engine on each data row's slice;
- `train --parallel --spatial 2` under torchrun;
- the band rule's errors, the mesh of a world of one.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpose_plus_tpu import checkpoint as jckpt
from openpose_plus_tpu import train as JT
from openpose_plus_tpu.config import default_config as jdefault_config
from openpose_plus_tpu.models import get_model as jget_model
from openpose_plus_tpu.parallel import kungfu as jkf
from openpose_plus_tpu.parallel import sharding as JS
from openpose_plus_tpu_torch import checkpoint as ckpt
from openpose_plus_tpu_torch import train as T
from openpose_plus_tpu_torch.checkpoint import from_flax
from openpose_plus_tpu_torch.config import default_config
from openpose_plus_tpu_torch.engine import Engine
from openpose_plus_tpu_torch.models import common, get_model
from openpose_plus_tpu_torch.parallel import spatial

from tests import torch_ranks
from tests.test_torch_parallel import (
    JAX_ALL_ATOL, JAX_LOSS_RTOL, JAX_MOST_ATOL, JAX_MOST_SHARE, PARAM_ATOL,
    PARAM_MAX, PARAM_SHARE, _configs, _jax_params, _loop_config,
    _param_diffs, _torch_named, _torchrun)
from tests.test_train import _fake_batch, _write_fake_dataset

torch.set_num_threads(2)

OPS_TOL = 1e-5          # gradients, of their scale
MAP_TOL = 1e-5          # maps, of their scale
GRAD_TOL = 1e-4         # summed parameter gradients, of each leaf's scale
STEPS = 2
WIDTH = 48
# (kernel or None for the pool, stride, depthwise) of every conv and pool
# in the zoo
OPS = [(3, 1, False), (3, 1, True), (7, 1, False), (1, 1, False),
       (3, 2, False), (3, 2, True), (None, 2, False)]
# per world size: (model, image height, remat) of the backbone runs
BACKBONES = {2: [("mobilenet_thin", 64, True), ("vgg19", 64, False),
                 ("vggtiny", 64, True), ("hao28", 64, False)],
             4: [("mobilenet_thin", 80, False), ("vgg19", 64, False),
                 ("vggtiny", 64, False), ("hao28", 80, True)]}
OPS_HOUT = {2: (8,), 4: (10, 8)}


def _op_name(hout, scale, kernel, stride, depthwise):
    what = "pool" if kernel is None else f"k{kernel}s{stride}" + (
        "dw" if depthwise else "")
    return f"hout{hout}-scale{scale}-{what}"


def _op_cases(world):
    """(name, x, weight, stride, groups, hout, cotangent) of every op at
    every level of the grid (stride 2 and the pool above the output
    grid)."""
    rng = np.random.default_rng(world)
    cases = []
    for hout in OPS_HOUT[world]:
        for scale in (8, 4, 2, 1):
            for kernel, stride, depthwise in OPS:
                if stride == 2 and scale == 1:
                    continue
                c, h = 4, hout * scale
                x = rng.normal(size=(2, c, h, 6)).astype(np.float32)
                w = None if kernel is None else rng.normal(size=(
                    c, 1 if depthwise else c, kernel, kernel)).astype(
                        np.float32)
                g = rng.normal(size=(2, c, h // stride, 6 // stride)
                               ).astype(np.float32)
                cases.append((_op_name(hout, scale, kernel, stride,
                                       depthwise), x, w, stride,
                              c if depthwise else 1, hout, g))
    return cases


def _backbone(name, hin, remat):
    """The port's model config, the Flax parameters bridged, a seeded
    batch, cotangents of every map; the unsharded port's last maps and
    parameter gradients, and the JAX model's last maps."""
    kw = dict(hin=hin, win=WIDTH, n_stages=2, compute_dtype="float32")
    jm = jget_model(dataclasses.replace(jdefault_config(name).model, **kw))
    rng = np.random.default_rng(hin)
    x = rng.uniform(-0.5, 0.5, (2, hin, WIDTH, 3)).astype(np.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    ref = jax.jit(jm.apply)(params, jnp.asarray(x))
    cfg = dataclasses.replace(default_config(name).model, remat_stages=remat,
                              **kw)
    state_dict = from_flax(jckpt._flatten(jax.device_get(params)))
    model = get_model(cfg)
    model.load_state_dict(state_dict)
    out = model(torch.from_numpy(x))
    maps = out["conf"] + out["paf"]
    cots = [rng.normal(size=m.shape).astype(np.float32) for m in maps]
    sum((m * torch.from_numpy(c)).sum() for m, c in zip(maps, cots)
        ).backward()
    return {"cfg": cfg, "state_dict": state_dict, "x": x, "cots": cots,
            "conf": out["conf"][-1].detach().numpy(),
            "paf": out["paf"][-1].detach().numpy(),
            "grads": {n: p.grad.numpy() for n, p in model.named_parameters()},
            "jax": {k: np.asarray(ref[k][-1]) for k in ("conf", "paf")}}


def _spatial(cfg, sp):
    return cfg.replace(parallel=dataclasses.replace(
        cfg.parallel, spatial_parallelism=sp))


def _engine_setup():
    """A tiny float32 MobileNet-thin with heads scaled so random weights
    decode to humans (tests/test_torch_parallel.py's `served`): its
    config, weights and 4 images."""
    cfg = default_config("mobilenet_thin")
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, hin=64, win=64, n_stages=2, compute_dtype="float32"))
    engine = Engine(cfg, seed=3, device="cpu")
    with torch.no_grad():
        engine.model.stages.stage2_conf.Conv_0.weight.mul_(400.0)
        engine.model.stages.stage2_paf.Conv_0.weight.mul_(1000.0)
    images = np.random.default_rng(0).integers(0, 256, (4, 64, 64, 3),
                                               dtype=np.uint8)
    return cfg, engine.model.state_dict(), images


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """One spawn of 2 ranks: the ops, the backbones, Engine on a 1x2 mesh
    and train_loop on 2 spatial ranks, beside their references."""
    cases = _op_cases(2)
    backbones = {b: _backbone(*b) for b in BACKBONES[2]}
    ecfg, state_dict, images = _engine_setup()
    tmp = tmp_path_factory.mktemp("spatial_loop")
    loop = _loop_config(tmp)            # checkpoints every STEPS steps
    loop = loop.replace(train=dataclasses.replace(
        loop.train, checkpoint_dir=str(tmp / "ck_one")))
    loop_sp = _spatial(loop, 2).replace(train=dataclasses.replace(
        loop.train, checkpoint_dir=str(tmp / "ck_spatial"), metrics_csv=""))
    parts = [("ops", "spatial_ops_rank", (cases,)),
             ("models", "spatial_model_rank", (
                 [(b, v["cfg"], v["state_dict"], v["x"], v["cots"])
                  for b, v in backbones.items()],)),
             ("engine", "spatial_engine_rank", (
                 _spatial(ecfg, 2), state_dict, images)),
             ("loop", "spatial_loop_rank", (loop_sp, STEPS))]
    ranks = torch_ranks.run_ranks(torch_ranks.spatial_world_rank, 2, parts,
                                  timeout=240)
    one = torch_ranks.spatial_loop_rank(0, 1, loop, STEPS)
    return {"cases": cases, "backbones": backbones, "ranks": ranks,
            "loop": (loop, loop_sp, one)}


@pytest.fixture(scope="module")
def world4():
    """One spawn of 4 ranks: the ops (uneven bands, wide halos), the
    backbones, sync-sgd on a 2x2 mesh and Engine on it, beside the
    references (the JAX 2x2 GSPMD step, the port's one-process step)."""
    cases = _op_cases(4)
    backbones = {b: _backbone(*b) for b in BACKBONES[4]}
    jcfg, cfg = _configs()
    cfg = _spatial(cfg, 2)
    rng = np.random.default_rng(0)
    batches = [_fake_batch(jcfg, rng) for _ in range(STEPS)]
    jparams = _jax_params(jcfg)
    flat = jckpt._flatten(jax.device_get(jparams))
    ecfg, state_dict, images = _engine_setup()
    parts = [("ops", "spatial_ops_rank", (cases,)),
             ("models", "spatial_model_rank", (
                 [(b, v["cfg"], v["state_dict"], v["x"], v["cots"])
                  for b, v in backbones.items()],)),
             ("train", "spatial_train_rank", (flat, batches, cfg)),
             ("engine", "spatial_engine_rank", (
                 _spatial(ecfg, 2), state_dict, images))]
    ranks = torch_ranks.run_ranks(torch_ranks.spatial_world_rank, 4, parts,
                                  timeout=240)

    jcfg2 = _spatial(jcfg, 2)
    mesh = JS.build_mesh(jcfg2.parallel, devices=jax.devices()[:4])
    tx = JT.make_optimizer(jcfg.train, jcfg.model.hout * jcfg.model.wout)
    state = jax.device_put(JT.TrainState(
        step=jnp.zeros((), jnp.int32), params=jparams,
        opt_state=tx.init(jparams)), JS.replicated(mesh))
    step = JT.make_train_step_on_batch(jcfg2)
    ref = []
    for batch in batches:
        state, m = step(state, JS.shard_batch(batch, mesh))
        ref.append((float(m["loss"]), _torch_named(state.params)))
    jerrors = {}
    for strategy in ("sma", "pair-avg"):
        with pytest.raises(ValueError) as e:
            jkf.make_kungfu_steps(jcfg2, mesh, strategy)
        jerrors[strategy] = str(e.value)

    one = T.create_train_state(cfg, device="cpu")
    one.model.load_state_dict(from_flax(flat))
    plain = []
    for batch in batches:
        one, m = T.make_train_step_on_batch(cfg)(one, batch)
        plain.append((float(m["loss"]), torch_ranks.params_np(one.model)))
    return {"cases": cases, "backbones": backbones, "ranks": ranks,
            "ref": ref, "jerrors": jerrors, "plain": plain}


@pytest.fixture(params=[2, 4], ids=["2ranks", "4ranks"])
def world(request):
    return request.getfixturevalue(f"world{request.param}")


# ------------------------------------------------------------ the ops ---

def _reads(hout, n, s, scale, kernel, stride):
    """The global rows rank s's output band of a SAME conv reads, as a
    set, from the unsharded geometry (no padding rows)."""
    h = hout * scale
    out = h // stride
    total = max((out - 1) * stride + kernel - h, 0)
    top = total // 2
    lo, hi = s * hout // n, (s + 1) * hout // n
    per = scale // stride
    rows = set()
    for o in range(lo * per, hi * per):
        rows.update(range(o * stride - top, o * stride - top + kernel))
    return {r for r in rows if 0 <= r < h}


def test_band_ops_match_unsharded(world):
    """Every op at every level: the output bands concatenated equal the
    unsharded output bit for bit; the gradient bands and the summed weight
    gradient within OPS_TOL of their scale."""
    for name, x, w, stride, groups, hout, g in world["cases"]:
        xt = torch.from_numpy(x).requires_grad_()
        wt = None if w is None else torch.from_numpy(w).requires_grad_()
        y = (common.maxpool2x2(xt) if wt is None
             else common.conv2d_same(xt, wt, stride, groups))
        (y * torch.from_numpy(g)).sum().backward()
        outs = [r["ops"][name] for r in world["ranks"]]
        np.testing.assert_array_equal(
            np.concatenate([o["y"] for o in outs], axis=2),
            y.detach().numpy(), err_msg=name)
        dx = np.concatenate([o["dx"] for o in outs], axis=2)
        scale = np.abs(xt.grad.numpy()).max()
        assert np.abs(dx - xt.grad.numpy()).max() <= OPS_TOL * scale, name
        if wt is not None:
            dw = sum(o["dw"] for o in outs)
            scale = np.abs(wt.grad.numpy()).max()
            assert np.abs(dw - wt.grad.numpy()).max() <= OPS_TOL * scale, \
                name


def test_exchange_moves_only_halo_rows(world):
    """Each rank's forward exchange brings the rows its band's outputs
    read beyond its own (not the padding), x width x channels x batch, and
    its backward brings back the gradients of the rows the other ranks
    read of it; 1x1 convs and pools exchange nothing (no collective)."""
    n = len(world["ranks"])
    for name, x, w, stride, groups, hout, g in world["cases"]:
        b, c, h, width = x.shape
        scale = h // hout
        kernel = 2 if w is None else w.shape[-1]
        for s, r in enumerate(world["ranks"]):
            own = set(range(s * hout // n * scale, (s + 1) * hout // n
                            * scale))
            halo = 0 if w is None else len(
                _reads(hout, n, s, scale, kernel, stride) - own)
            sent = 0 if w is None else sum(
                len(_reads(hout, n, j, scale, kernel, stride) & own)
                for j in range(n) if j != s)
            assert r["ops"][name]["elements"] == (
                halo * width * c * b, sent * width * c * b), (name, s)
            if w is None or kernel == 1:
                assert r["ops"][name]["calls"] == 0, name
        # a band holds its own rows only: 1/n of the activation
        assert sum(r["ops"][name]["y"].shape[2]
                   for r in world["ranks"]) == h // stride


# ------------------------------------------------------- the backbones ---

def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


BACKBONE_NAMES = ["mobilenet_thin", "vgg19", "vggtiny", "hao28"]


def _runs_of(world, name):
    runs = {k: v for k, v in world["backbones"].items() if k[0] == name}
    assert runs
    return runs


@pytest.mark.parametrize("name", BACKBONE_NAMES)
def test_backbone_forward_matches_unsharded_and_jax(world, name):
    for key, ref in _runs_of(world, name).items():
        for rank, r in enumerate(world["ranks"]):
            out = r["models"][key]
            for m in ("conf", "paf"):
                assert out[m].shape == ref[m].shape
                assert _rel(out[m], ref[m]) <= MAP_TOL, (key, rank, m)
                assert _rel(out[m], ref["jax"][m]) <= MAP_TOL, (key, rank, m)


@pytest.mark.parametrize("name", BACKBONE_NAMES)
def test_backbone_gradients_sum_to_unsharded(world, name):
    """The parameter gradients of sum(maps * cotangents), summed over the
    ranks, against the unsharded backward (remat runs recompute their
    branches, exchanges and all, in the backward pass)."""
    for key, ref in _runs_of(world, name).items():
        out = world["ranks"][0]["models"][key]
        assert out["grads"].keys() == ref["grads"].keys()
        for name, g in ref["grads"].items():
            err = np.abs(out["grads"][name] - g).max()
            assert err <= GRAD_TOL * np.abs(g).max(), (key, name)
        calls = [r["models"][key]["stats"]["halo_calls"]
                 for r in world["ranks"]]
        assert len(set(calls)) == 1 and calls[0] > 0
        assert all(r["models"][key]["stats"]["gather_calls"] == 1
                   for r in world["ranks"])


def test_remat_recomputes_the_exchanges(world2):
    """remat_stages=True adds the stage branches' exchanges again in the
    backward pass, on every rank alike: MobileNet-thin's 2 stages x 2
    branches x 3 separable convs."""
    stats = {key[0]: [r["models"][key]["stats"]["halo_calls"]
                      for r in world2["ranks"]]
             for key in world2["backbones"] if key[2]}
    assert set(stats) == {"mobilenet_thin", "vggtiny"}
    assert stats["mobilenet_thin"] == [55, 55]


# ---------------------------------------------------------- sync-sgd ---

def test_sync_sgd_2x2_matches_jax_gspmd(world4):
    ranks = world4["ranks"]
    assert [r["train"]["axes"] for r in ranks] == [
        ((d, 2), (s, 2)) for d in range(2) for s in range(2)]
    for i, (loss, params) in enumerate(world4["ref"]):
        for rank, r in enumerate(ranks):
            step = r["train"]["steps"][i]
            what = f"step {i + 1} rank {rank}"
            np.testing.assert_allclose(step["loss"], loss,
                                       rtol=JAX_LOSS_RTOL, err_msg=what)
            diff = _param_diffs(step["params"], params)
            assert diff.max() <= JAX_ALL_ATOL, what
            assert (diff <= JAX_MOST_ATOL).mean() >= JAX_MOST_SHARE, what


def test_sync_sgd_2x2_matches_one_process(world4):
    ranks = world4["ranks"]
    for i, (loss, params) in enumerate(world4["plain"]):
        assert len({r["train"]["steps"][i]["digest"] for r in ranks}) == 1
        for rank, r in enumerate(ranks):
            step = r["train"]["steps"][i]
            what = f"step {i + 1} rank {rank}"
            np.testing.assert_allclose(step["loss"], loss, rtol=1e-6,
                                       err_msg=what)
            diff = _param_diffs(step["params"], params)
            assert diff.max() <= PARAM_MAX, what
            assert (diff <= PARAM_ATOL).mean() >= PARAM_SHARE, what


@pytest.mark.parametrize("strategy", ["sma", "pair-avg"])
def test_decentralized_strategies_refuse_the_spatial_axis(world4, strategy):
    for r in world4["ranks"]:
        assert r["train"]["errors"][strategy] == world4["jerrors"][strategy]


# ------------------------------------------------------ loop and engine ---

def test_train_loop_on_two_spatial_ranks(world2):
    """Both ranks step on the bands of the one-process run's batches (the
    row's reader broadcasts each), and rank 0's checkpoint equals that
    run's parameters within PARAM_MAX."""
    loop, loop_sp, one = world2["loop"]
    ranks = [r["loop"] for r in world2["ranks"]]
    assert [r["step"] for r in ranks] == [STEPS, STEPS]
    assert len({r["digest"] for r in ranks}) == 1
    for i, want in enumerate(one["batches"]):
        got = [r["batches"][i] for r in ranks]
        np.testing.assert_array_equal(
            np.concatenate([g["images"] for g in got], axis=1),
            want["images"])
        assert got[0]["images"].shape[1] == loop.model.hin // 2
        for g in got:
            for k in ("keypoints", "mask"):
                np.testing.assert_array_equal(g[k], want[k])
    assert ckpt.latest_step(loop_sp.train.checkpoint_dir) == STEPS
    saved = T.create_train_state(loop_sp, device="cpu")
    saved = ckpt.restore(loop_sp.train.checkpoint_dir, saved)
    ref = ckpt.restore(loop.train.checkpoint_dir,
                       T.create_train_state(loop, device="cpu"))
    diff = _param_diffs(torch_ranks.params_np(saved.model),
                        torch_ranks.params_np(ref.model))
    assert diff.max() <= PARAM_MAX


@pytest.mark.parametrize("size", [2, 4], ids=["1x2", "2x2"])
def test_mesh_engine_on_spatial_mesh(world2, world4, size):
    """Every rank holds the whole HumanBatch and maps, bit-equal to an
    unsharded engine's on each data row's slice (run in the rank), and to
    rank 0's."""
    world = world2 if size == 2 else world4
    ranks = [r["engine"] for r in world["ranks"]]
    for r in ranks:
        assert r["humans"]["coords"].shape[0] == 4
        for name, want in r["slices"].items():
            np.testing.assert_array_equal(r["humans"][name], want, name)
            np.testing.assert_array_equal(r["humans"][name],
                                          ranks[0]["humans"][name], name)
        for got, want, first in zip(r["maps"], r["slice_maps"],
                                    ranks[0]["maps"]):
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, first)
    assert int(ranks[0]["humans"]["valid"].sum()) >= 1


# -------------------------------------------------------------- errors ---

def test_band_rule_errors():
    with pytest.raises(ValueError, match="image height 65 is not divisible "
                                         "by the output stride 8"):
        spatial.check_geometry(65, 8, 2)
    with pytest.raises(ValueError, match="2 rows, fewer than the 4"):
        spatial.check_geometry(16, 8, 4)
    assert spatial.check_geometry(80, 8, 4) == 10
    assert spatial.bands(10, 4) == [(0, 2), (2, 5), (5, 7), (7, 10)]
    band = spatial.Band(1, 4, None, 10, 8)
    with pytest.raises(ValueError, match="not its band of 3 output rows"):
        band.scale(5)
    with pytest.raises(ValueError, match="a 2x2 pool on the output grid"):
        spatial.check_pool(band, torch.zeros(1, 1, 3, 4))


@pytest.mark.parametrize("n", [2, 3, 4])
def test_plans_pair_up(n):
    """What each rank plans to send to another is what that one plans to
    receive from it, for every op and level, even and uneven bands."""
    for hout in (n, 7, 10):
        plans = [spatial.Band(s, n, None, hout, 8) for s in range(n)]
        for scale in (8, 4, 2, 1):
            for kernel, stride, _ in OPS:
                if kernel is None or (stride == 2 and scale == 1):
                    continue
                top = max((hout * scale // stride - 1) * stride + kernel
                          - hout * scale, 0) // 2
                ps = [b.plan(scale, kernel, stride, top) for b in plans]
                for s, p in enumerate(ps):
                    for j, first, stop in p.send:
                        a = plans[s].lo * scale
                        assert (s, a + first, a + stop) in ps[j].recv
                    assert len(p.recv) == sum(
                        any(d == s for d, _, _ in q.send) for q in ps)
                assert all(b.reads_own_rows(scale, kernel, stride, top)
                           == (kernel == 1) for b in plans)


def test_train_on_a_world_of_one_refuses_spatial(tmp_path):
    """The reference's mesh error: one device is not divisible by two."""
    cfg = _spatial(_loop_config(tmp_path), 2)
    with pytest.raises(ValueError, match="1 devices not divisible by "
                                         "spatial=2"):
        T.train_loop(cfg, n_steps=1, device="cpu")


def test_cli_train_spatial_under_torchrun(tmp_path):
    """Two ranks, one data row: rank 0 writes the checkpoint and CSV."""
    ann, imgs = _write_fake_dataset(tmp_path)
    ck, csv = tmp_path / "ck", tmp_path / "m.csv"
    proc = _torchrun(["train", "--parallel", "--spatial", "2",
                      "--device", "cpu", "--model", "mobilenet_thin",
                      "--steps", "2", "--batch-size", "2",
                      "--train-images", imgs, "--train-annotations", ann,
                      "--checkpoint-dir", str(ck), "--metrics-csv", str(csv),
                      "--checkpoint-every", "2"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert os.listdir(ck) == ["2"]
    assert open(csv).read().splitlines() == [
        "step,loss,loss_conf_last,loss_paf_last,lr,imgs_per_sec"]
