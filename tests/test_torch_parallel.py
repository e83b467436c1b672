"""The port's distributed layer (`openpose_plus_tpu_torch.parallel`) against
the JAX package's (`openpose_plus_tpu.parallel`) on the CPU.

The port runs as gloo ranks in spawned processes (tests/torch_ranks.py),
the reference on a mesh of its virtual CPU devices
(`build_mesh(cfg.parallel, devices=jax.devices()[:n])`), on the same seeded
parameters and batches (tests/test_train.py's `_tiny_config` and
`_fake_batch`: VGG-tiny, 64x64, 2 stages, float32, a global batch of 8;
momentum SGD at lr 1e-2, linear in the gradients). For each strategy, 4
ranks, 2 steps (pair-avg: both hypercube rounds), each rank's loss and
parameters against

- the plain version of the strategy on the port's one-process step (each
  rank's slice stepped alone, then the strategy's mean or pair average;
  for sync-sgd the step on the global batch): the same to float32
  rounding (at most 6e-8 measured), but that sma's mean of 4 summed in
  another order than gloo's moves parameters by an ulp, which the next
  step's ReLU boundaries amplify in a few elements (measured after sma's
  step 2: 99.993% within 1e-6, at most 9.3e-6): 99.9% within 1e-6, every
  one within 2e-5;
- the reference's `make_kungfu_steps` replica of the same index (for
  sync-sgd too: the reference's single-device step at batch 8 puts its
  loss 1.6e-5 relative from the ranks', its sync-sgd program on batches
  of 2 3.1e-6): the loss within 1e-5 relative; the parameters within half
  an lr step, 95% of them within 1e-5. The two packages' float32
  gradients put a few ReLU pre-activations on opposite sides of 0 (2 of 8
  images move one bias element of a stage-2 layer by 1e-3 in one step),
  and momentum carries those into the next step (measured: 99.99% within
  1e-5 after step 1, 96.9% after step 2; at most 2.1e-3);

and the replicas bit-identical where the strategy makes them so (all of
them under sync-sgd and sma, a round's partners under pair-avg). Also:
pair-avg at lr 0 from distinct replicas averages XOR partners and keeps the
global mean;
- the strategies' and the mesh's errors; `process_local_slice` over a grid
  of (count, rank, world) against the reference's arithmetic;
- the eval gather's packing against the reference's, and payloads whose
  shapes differ by rank through the padded gather (2 ranks);
- `Engine(mesh=)` with 2 ranks: every rank returns the whole HumanBatch,
  bit-equal to an unsharded engine on each rank's slice; an int8 mesh
  engine calibrates to one engine's scales; distributed `evaluate_engine`
  equals the unsharded call;
- `train_loop` with sma on 2 ranks: rank 0 alone writes checkpoints and CSV
  rows, resume works; the CLI under torchrun (`train --parallel`, `eval
  --distributed`).
"""

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openpose_plus_tpu import checkpoint as jckpt
from openpose_plus_tpu import eval_coco as JE
from openpose_plus_tpu import train as JT
from openpose_plus_tpu.models import get_model as jget_model
from openpose_plus_tpu.parallel import kungfu as jkf
from openpose_plus_tpu.parallel import sharding as JS
from openpose_plus_tpu_torch import cli
from openpose_plus_tpu_torch import eval_coco as TE
from openpose_plus_tpu_torch import train as T
from openpose_plus_tpu_torch.checkpoint import from_flax
from openpose_plus_tpu_torch.config import default_config
from openpose_plus_tpu_torch.engine import Engine
from openpose_plus_tpu_torch.parallel import kungfu as kf
from openpose_plus_tpu_torch.parallel import sharding as S

from tests import torch_ranks
from tests.test_train import _fake_batch, _tiny_config, _write_fake_dataset

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
STEPS = 2
PARAM_ATOL = 1e-6       # against the plain version on the port's step:
PARAM_SHARE = 0.999     # this share of the parameters,
PARAM_MAX = 2e-5        # and every one
JAX_LOSS_RTOL = 1e-5
JAX_MOST_ATOL = 1e-5    # against the reference: 95% of the parameters,
JAX_MOST_SHARE = 0.95
JAX_ALL_ATOL = 5e-3     # and every one within half an lr step


def _configs(batch=8, **train):
    """_tiny_config in both packages, with momentum SGD at lr 1e-2."""
    tr = dict(optimizer="momentum", lr_init=1e-2, **train)
    jcfg = _tiny_config(batch=batch)
    jcfg = jcfg.replace(train=dataclasses.replace(jcfg.train, **tr))
    cfg = default_config("vggtiny")
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, hin=64, win=64, n_stages=2,
                                  compute_dtype="float32"),
        train=dataclasses.replace(cfg.train, batch_size=batch,
                                  weight_decay=0.0, **tr))
    return jcfg, cfg


def _torch_named(jparams) -> dict:
    return {k: v.numpy() for k, v in from_flax(
        jckpt._flatten(jax.device_get(jparams))).items()}


def _jax_params(jcfg, seed=0):
    m = jcfg.model.train_lowering()
    return jax.jit(jget_model(m).init)(jax.random.PRNGKey(seed),
                                       jnp.zeros((1, m.hin, m.win, 3)))


def _param_diffs(out: dict, ref: dict) -> np.ndarray:
    assert out.keys() == ref.keys()
    return np.concatenate([np.abs(out[n] - r).ravel()
                           for n, r in ref.items()])


def _plain(cfg, flat, batches, strategy) -> list:
    """The strategy without collectives, on the port's one-process step:
    per step (the ranks' mean loss, each rank's parameters)."""
    step = T.make_train_step_on_batch(cfg)
    per = cfg.train.batch_size // N
    if strategy == "sync-sgd":
        state = T.create_train_state(cfg, device="cpu")
        state.model.load_state_dict(from_flax(flat))
        out = []
        for batch in batches:
            state, m = step(state, batch)
            out.append((float(m["loss"]),
                        [torch_ranks.params_np(state.model)] * N))
        return out
    states = []
    for _ in range(N):
        states.append(T.create_train_state(cfg, device="cpu"))
        states[-1].model.load_state_dict(from_flax(flat))
    out = []
    for i, batch in enumerate(batches):
        losses = [float(step(st, {k: v[r * per:(r + 1) * per]
                                  for k, v in batch.items()})[1]["loss"])
                  for r, st in enumerate(states)]
        params = [list(st.model.parameters()) for st in states]
        with torch.no_grad():
            if strategy == "sma":
                new = [[sum(ps) / N for ps in zip(*params)]] * N
            else:
                new = [[(a + b) * 0.5 for a, b in zip(
                    params[r], params[r ^ (1 << i)])] for r in range(N)]
            for ps, values in zip(params, new):
                for p, v in zip(ps, values):
                    p.copy_(v)
        out.append((float(np.mean(losses)),
                    [torch_ranks.params_np(st.model) for st in states]))
    return out


@pytest.fixture(scope="module")
def strategies():
    """The port's ranks, the reference's `make_kungfu_steps` on N virtual
    devices (one compile a strategy, two for pair-avg's rounds) and the
    port's single-process step on the global batch, on the same parameters
    and batches."""
    jcfg, cfg = _configs()
    rng = np.random.default_rng(0)
    batches = [_fake_batch(jcfg, rng) for _ in range(STEPS)]
    jparams = _jax_params(jcfg)
    flat = jckpt._flatten(jax.device_get(jparams))
    lr0 = cfg.replace(train=dataclasses.replace(cfg.train, lr_init=0.0))
    runs = [("sync-sgd", "sync-sgd", cfg, 0.0), ("sma", "sma", cfg, 0.0),
            ("pair-avg", "pair-avg", cfg, 0.0),
            ("pair-avg lr0", "pair-avg", lr0, 1e-3)]
    port = torch_ranks.run_ranks(torch_ranks.kungfu_rank, N, flat, batches,
                                 runs)

    tx = JT.make_optimizer(jcfg.train, jcfg.model.hout * jcfg.model.wout)
    mesh = JS.build_mesh(jcfg.parallel, devices=jax.devices()[:N])
    ref = {}
    for strategy in kf.STRATEGIES:
        state = JT.TrainState(
            step=jnp.zeros((N,), jnp.int32),
            params=jkf.stack_for_devices(jparams, N),
            opt_state=jkf.stack_for_devices(tx.init(jparams), N))
        state = jax.device_put(state, jkf.replica_sharding(mesh))
        fns = jkf.make_kungfu_steps(jcfg, mesh, strategy)
        ref[strategy] = []
        for i, batch in enumerate(batches):
            state, m = fns[i % len(fns)](state, JS.shard_batch(batch, mesh))
            ref[strategy].append((float(m["loss"]), [
                _torch_named(jkf.unstack_replica(state.params, r))
                for r in range(N)]))
    plain = {strategy: _plain(cfg, flat, batches, strategy)
             for strategy in kf.STRATEGIES}
    return port, ref, plain


@pytest.mark.parametrize("strategy", ["sync-sgd", "sma", "pair-avg"])
def test_strategy_matches_reference(strategies, strategy):
    """Per step: each rank's mean loss and parameters against the
    reference's replica of the same index (tolerances in the module
    docstring)."""
    port, ref, _ = strategies
    assert port[0][strategy]["n_fns"] == (2 if strategy == "pair-avg" else 1)
    for i, (loss, replicas) in enumerate(ref[strategy]):
        for r in range(N):
            step = port[r][strategy]["steps"][i]
            what = f"{strategy} step {i + 1} rank {r}"
            np.testing.assert_allclose(step["loss"], loss,
                                       rtol=JAX_LOSS_RTOL, err_msg=what)
            diff = _param_diffs(step["params"], replicas[r])
            assert diff.max() <= JAX_ALL_ATOL, what
            assert (diff <= JAX_MOST_ATOL).mean() >= JAX_MOST_SHARE, what


@pytest.mark.parametrize("strategy", ["sync-sgd", "sma", "pair-avg"])
def test_strategy_matches_plain_version(strategies, strategy):
    """Per step: each rank's mean loss and parameters against the strategy
    computed without collectives on the port's one-process step."""
    port, _, plain = strategies
    for i, (loss, replicas) in enumerate(plain[strategy]):
        for r in range(N):
            step = port[r][strategy]["steps"][i]
            what = f"{strategy} step {i + 1} rank {r}"
            np.testing.assert_allclose(step["loss"], loss, rtol=1e-6,
                                       err_msg=what)
            diff = _param_diffs(step["params"], replicas[r])
            assert diff.max() <= PARAM_MAX, what
            assert (diff <= PARAM_ATOL).mean() >= PARAM_SHARE, what


@pytest.mark.parametrize("strategy", ["sync-sgd", "sma", "pair-avg"])
def test_replicas_bit_identical(strategies, strategy):
    """sync-sgd and sma: every rank's parameters equal bit for bit after
    every step; pair-avg: the partners of each round (rank XOR 2^r), and
    the ranks' replicas differ otherwise."""
    port = strategies[0]
    for i in range(STEPS):
        digests = [port[r][strategy]["steps"][i]["digest"] for r in range(N)]
        if strategy == "pair-avg":
            assert all(digests[r] == digests[r ^ (1 << i)]
                       for r in range(N))
            assert len(set(digests)) == N // 2
        else:
            assert len(set(digests)) == 1


def test_pair_avg_gossip_at_lr0(strategies):
    """lr 0 isolates the averaging (tests/test_kungfu.py): from replicas
    p + 1e-3 * rank, round 0 gives (b_i + b_{i^1}) / 2 and keeps the mean,
    round 1 leaves every replica at the mean."""
    port = strategies[0]
    runs = [port[r]["pair-avg lr0"] for r in range(N)]
    before = [run["start"] for run in runs]
    after = [[run["steps"][i]["params"] for run in runs]
             for i in range(STEPS)]
    for name in before[0]:
        mean = np.mean([b[name] for b in before], axis=0)
        for r in range(N):
            np.testing.assert_allclose(
                after[0][r][name], (before[r][name] + before[r ^ 1][name]) / 2,
                atol=1e-6)
            np.testing.assert_allclose(after[1][r][name], mean, atol=1e-5)
        np.testing.assert_allclose(
            np.mean([a[name] for a in after[0]], axis=0), mean, atol=1e-6)
    assert len({run["steps"][1]["digest"] for run in runs}) == 1


def test_strategy_errors(strategies):
    """The reference's messages: an unknown strategy, and pair-avg on 3
    ranks (a mesh of ranks 0-2) and on a world of one."""
    port = strategies[0]
    jcfg, cfg = _configs()
    with pytest.raises(ValueError) as ref:
        jkf.make_kungfu_steps(jcfg, JS.build_mesh(jcfg.parallel), "bogus")
    with pytest.raises(ValueError) as out:
        kf.make_kungfu_steps(cfg, None, "bogus")
    assert str(out.value) == str(ref.value)
    with pytest.raises(ValueError) as ref:
        jkf.make_kungfu_steps(
            jcfg, JS.build_mesh(jcfg.parallel, devices=jax.devices()[:3]),
            "pair-avg")
    assert [port[r].get("three") for r in range(N)] == [str(ref.value)] * 3 \
        + [None]
    with pytest.raises(ValueError, match="power-of-two device count, got 1"):
        kf.make_kungfu_steps(cfg, None, "pair-avg")
    assert len(kf.make_kungfu_steps(cfg, None, "sma")) == 1


@pytest.mark.parametrize("rnd", [0, 1, 2])
def test_pair_index_covers_each_pair_once(rnd):
    n = 8
    idx = [kf.pair_index(r, rnd) for r in range(n)]
    assert sorted(set(idx)) == list(range(n // 2))
    assert all(idx[r] == idx[r ^ (1 << rnd)] for r in range(n))


# -------------------------------------------------------------- sharding ---

def test_process_local_slice_matches_jax(monkeypatch):
    grid = []
    for world in (1, 2, 3, 4, 8):
        for count in (0, 1, 5, 10, 12, 13):
            for rank in range(world):
                monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
                monkeypatch.setattr(jax, "process_count", lambda w=world: w)
                monkeypatch.setattr(S, "rank_and_world",
                                    lambda r=rank, w=world: (r, w))
                grid.append((S.process_local_slice(count),
                             JS.process_local_slice(count)))
    assert len(grid) == 6 * 18
    assert all(out == ref for out, ref in grid)
    monkeypatch.undo()
    assert S.process_local_slice(7) == (0, 7)      # no process group


def test_build_mesh_errors(strategies):
    """The reference's `n % spatial` error, a 1 x 2 (data, spatial) mesh
    over ranks 0-1 of the strategies' world, and a mesh without a process
    group."""
    jcfg, cfg = _configs()
    sp = dataclasses.replace(cfg.parallel, spatial_parallelism=2)
    with pytest.raises(ValueError) as ref:
        JS.build_mesh(dataclasses.replace(jcfg.parallel,
                                          spatial_parallelism=2),
                      devices=jax.devices()[:3])
    with pytest.raises(ValueError) as out:
        S.build_mesh(sp, devices=[0, 1, 2])
    assert str(out.value) == str(ref.value)
    port = strategies[0]
    assert [port[r].get("spatial_mesh") for r in range(N)] == [
        ([[0, 1]], ("data", "spatial"), (0, 1), (s, 2)) for s in (0, 1)] \
        + [None, None]
    with pytest.raises(RuntimeError, match="init_distributed"):
        S.build_mesh(cfg.parallel)
    # without multihost, a world of one: no group is started
    assert S.init_distributed(cfg.parallel, device="cpu") == \
        torch.device("cpu")
    assert S.rank_and_world() == (0, 1)


# --------------------------------------------------------- eval packing ---

def _payloads(seed):
    rng = np.random.default_rng(seed)
    dets = [TE.Detection(image_id=int(rng.integers(0, 50)),
                         keypoints=rng.normal(0, 50, (17, 3)).astype(
                             np.float32),
                         score=float(rng.uniform()))
            for _ in range(int(rng.integers(0, 6)))]
    gt = {}
    for img in range(int(rng.integers(1, 5))):
        g, q = int(rng.integers(0, 4)), int(rng.integers(0, 3))
        entry = (rng.normal(0, 50, (g, 17, 3)).astype(np.float32),
                 rng.uniform(100, 900, (g,)).astype(np.float32))
        if q or img % 2:
            entry += (rng.uniform(0, 60, (q, 4)).astype(np.float32),)
        gt[100 + img] = entry
    return dets, gt


@pytest.mark.parametrize("seed", range(4))
def test_eval_packing_matches_jax(seed):
    """_pack_detections / _pack_gt and their unpacks on the same inputs
    (empty payloads, 2- and 3-tuple GT entries) equal the reference's,
    also on two ranks' packs padded and stacked as the gather lays them
    out."""
    dets, gt = _payloads(seed)
    jdets = [JE.Detection(d.image_id, d.keypoints, d.score) for d in dets]
    for pack, jpack, payload, jpayload in (
            (TE._pack_detections, JE._pack_detections, dets, jdets),
            (TE._pack_gt, JE._pack_gt, gt, gt)):
        np.testing.assert_array_equal(pack(payload), jpack(jpayload))
    other_dets, other_gt = _payloads(seed + 10)
    for pack, unpack, junpack, a, b in (
            (TE._pack_detections, TE._unpack_detections,
             JE._unpack_detections, dets, other_dets),
            (TE._pack_gt, TE._unpack_gt, JE._unpack_gt, gt, other_gt)):
        packs = [pack(a), pack(b)]
        m = max(p.shape[0] for p in packs)
        w = max(p.shape[1] for p in packs)
        padded = np.zeros((2, m, w), np.float32)
        padded[:, :, 0] = -1.0
        for i, p in enumerate(packs):
            padded[i, :p.shape[0], :p.shape[1]] = p
        stacked = padded.reshape(-1, w)
        out, ref = unpack(stacked), junpack(stacked)
        if isinstance(out, dict):
            assert out.keys() == ref.keys()
            for k in out:
                for x, y in zip(out[k], ref[k]):
                    np.testing.assert_array_equal(x, y)
        else:
            assert [(d.image_id, d.score) for d in out] == \
                [(d.image_id, d.score) for d in ref]
            for d, r in zip(out, ref):
                np.testing.assert_array_equal(d.keypoints, r.keypoints)
    assert TE._allgather_padded(np.ones((2, 3), np.float32)).shape == (2, 3)


# ------------------------------------------------ serving and evaluation ---

@pytest.fixture(scope="module")
def served():
    """Engine(mesh=) and distributed evaluate_engine on 2 ranks: a tiny
    float32 MobileNet-thin, heads scaled so random weights decode to
    humans (tests/test_torch_engine.py), 4 images; a 12-image bank."""
    cfg = default_config("mobilenet_thin")
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, hin=64, win=64, n_stages=2, compute_dtype="float32"))
    engine = Engine(cfg, seed=3, device="cpu")
    with torch.no_grad():
        engine.model.stages.stage2_conf.Conv_0.weight.mul_(400.0)
        engine.model.stages.stage2_paf.Conv_0.weight.mul_(1000.0)
    eval_cfg = cfg.replace(postproc=dataclasses.replace(
        cfg.postproc, peak_threshold=0.0, paf_sample_threshold=-1.0,
        paf_inlier_ratio=0.0, min_parts_per_human=1))
    images = np.random.default_rng(0).integers(0, 256, (4, 64, 64, 3),
                                               dtype=np.uint8)
    bank = torch_ranks.scene_bank()
    state_dict = engine.model.state_dict()
    try:
        yield images, cfg, state_dict, torch_ranks.run_ranks(
            torch_ranks.serving_rank, 2, cfg, state_dict, images, bank,
            eval_cfg)
    finally:
        shutil.rmtree(bank[2])


@pytest.mark.parametrize("call", ["infer", "flip", "dedup"])
def test_mesh_engine_equals_unsharded_slices(served, call):
    """Every rank holds the whole HumanBatch of the global batch, bit-equal
    to an unsharded engine's on each rank's slice."""
    images, _, _, ranks = served
    for out in ranks:
        assert out[call]["coords"].shape[0] == len(images)
        for name, ref in ranks[0][call + "_slices"].items():
            np.testing.assert_array_equal(out[call][name], ref, name)
    assert int(ranks[0]["infer"]["valid"].sum()) >= 1


def test_mesh_engine_forward_compile_and_errors(served):
    ranks = served[-1]
    for out in ranks:
        assert out["forward_equal"] and out["compiled_equal"]
        assert "not divisible by the mesh's data axis (2 ranks)" in \
            out["indivisible"]
    assert [out["local"] for out in ranks] == [(0, 5), (5, 10)]
    with pytest.raises(TypeError, match="DeviceMesh"):
        Engine(default_config("mobilenet_thin"), mesh=object(), device="cpu")


def test_mesh_engine_int8_calibration(served):
    """An int8 mesh engine calibrated on the global batch (each rank its
    slice, the scales' max over the ranks) holds the scales of one engine
    calibrated on the whole batch, bit for bit."""
    images, cfg, state_dict, ranks = served
    one = Engine(cfg.replace(model=dataclasses.replace(
        cfg.model, compute_dtype="int8")), params=state_dict, device="cpu")
    one.calibrate(images)
    assert len(one._calib) > 0 and all(float(b.min()) > 0 for b in one._calib)
    for out in ranks:
        assert len(out["int8_scales"]) == len(one._calib)
        for got, want in zip(out["int8_scales"], one._calib):
            np.testing.assert_array_equal(got, want.numpy())


def test_distributed_evaluate_engine_equals_unsharded(served):
    ranks = served[-1]
    for out in ranks:
        single, dist_res = out["eval_single"], out["eval_dist"]
        assert single.n_images == 12 and single.n_dets > 0
        assert dist_res.as_dict() == single.as_dict()


def test_host_gather_of_uneven_payloads(served):
    """Detections and GT whose counts and widths differ by rank
    (scripts/multiprocess_smoke.py's case): every rank gets every row."""
    ranks = served[-1]
    for dets, gt in (out["gathered"] for out in ranks):
        assert len(dets) == 3 + 5
        assert sorted(d.image_id for d in dets) == sorted(
            [*range(3), *range(100, 105)])
        assert set(gt) == {1000, 1001}
        for r in range(2):
            kps, areas, ign = gt[1000 + r]
            assert kps.shape == (1 + r, 17, 3) and ign.shape == (r, 4)


# -------------------------------------------------------------- the loop ---

def _loop_config(tmp_path, **train):
    ann, imgs = _write_fake_dataset(tmp_path)
    _, cfg = _configs(batch=4)
    return cfg.replace(
        data=dataclasses.replace(cfg.data, train_annotations=ann,
                                 train_images=imgs, num_workers=1,
                                 prefetch=2),
        train=dataclasses.replace(
            cfg.train, log_every=1, checkpoint_every=2,
            checkpoint_dir=str(tmp_path / "ck"),
            metrics_csv=str(tmp_path / "metrics.csv"), **train))


def test_train_loop_sma_on_two_ranks(tmp_path):
    """train_loop under sma on 2 ranks (tests/test_kungfu.py's
    train_loop case): rank 0 alone saves the checkpoint and writes the CSV
    rows, both ranks resume from it, the replicas stay equal."""
    cfg = _loop_config(tmp_path, kf_optimizer="sma")
    ranks = torch_ranks.run_ranks(torch_ranks.train_loop_rank, 2, cfg, 2)
    assert [out["saves"] for out in ranks] == [[2], []]
    assert os.listdir(tmp_path / "ck") == ["2"]
    rows = open(tmp_path / "metrics.csv").read().strip().splitlines()
    assert [r.split(",")[0] for r in rows[1:]] == ["1", "2"]
    for out in ranks:
        assert out["steps"] == [2, 2]
        assert "resumed from step 2" in out["logs"]
        assert sum(line.startswith("step ") for line in out["logs"]) == 2
    digests = {d for out in ranks for d in out["digests"]}
    assert len(digests) == 1


def _torchrun(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "openpose_plus_tpu_torch", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


def test_cli_train_parallel_under_torchrun(tmp_path):
    ann, imgs = _write_fake_dataset(tmp_path)
    ck, csv = tmp_path / "ck", tmp_path / "m.csv"
    proc = _torchrun(["train", "--parallel", "--kf-optimizer", "sma",
                      "--device", "cpu", "--model", "mobilenet_thin",
                      "--steps", "2", "--batch-size", "2",
                      "--train-images", imgs, "--train-annotations", ann,
                      "--checkpoint-dir", str(ck), "--metrics-csv", str(csv),
                      "--checkpoint-every", "2"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert os.listdir(ck) == ["2"]
    assert open(csv).read().splitlines() == [
        "step,loss,loss_conf_last,loss_paf_last,lr,imgs_per_sec"]
    with pytest.raises(ValueError) as ref:
        JS.build_mesh(JS.ParallelConfig(spatial_parallelism=2),
                      devices=jax.devices()[:1])
    with pytest.raises(ValueError) as out:
        cli.main(["train", "--spatial", "2", "--device", "cpu"])
    assert str(out.value) == str(ref.value) == \
        "1 devices not divisible by spatial=2"


def test_cli_eval_distributed_under_torchrun(tmp_path):
    """Each rank prints the AP of the whole bank, the unsharded call's."""
    from openpose_plus_tpu_torch.data.synthetic import make_scene_bank

    ann, imgs = make_scene_bank(str(tmp_path), "val", 6, 96)
    flags = ["--annotations", ann, "--images", imgs, "--device", "cpu",
             "--input-height", "64", "--input-width", "64", "--batch", "2"]
    proc = _torchrun(["eval", "--distributed", *flags])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    # the ranks' lines may interleave: read every JSON object printed
    lines = [json.loads(o) for o in re.findall(r"\{[^{}]*\}", proc.stdout)]
    env = dict(os.environ, PYTHONPATH=REPO)
    single = subprocess.run(
        [sys.executable, "-m", "openpose_plus_tpu_torch", "eval", *flags],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert single.returncode == 0, single.stderr
    assert lines == [json.loads(single.stdout.strip().splitlines()[-1])] * 2
    assert lines[0]["n_images"] == 6
