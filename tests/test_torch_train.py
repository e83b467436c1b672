"""The port's training (`openpose_plus_tpu_torch.train`, `checkpoint`)
against the JAX package's (`openpose_plus_tpu.train`, `checkpoint`) on the
CPU, float32 tiny configs (64x64, 2 stages, as tests/test_train.py), from
the same bridged parameters and the same batch:

- `pose_loss` with and without a mask, `effective_lr_init` and
  `lr_schedule` at and around the decay boundaries;
- one `make_train_step` / `make_train_step_on_batch` for VGG-tiny, hao28
  and MobileNet-thin: the loss within 1e-5 relative, every gradient within
  1e-4 of its leaf's largest magnitude; the parameters after 3 steps with
  Adam + weight decay and with momentum (tolerances at the tests);
- `remat_stages` gives the same gradients; the `fused_inference` and int8
  refusals; the strategies on a world of one (sma and multihost train,
  pair-avg and the spatial axis raise);
- checkpoints (`save` / `restore` / `latest_step`, keep=3), `save_npz`
  read back by the JAX package's `load_npz` with the same forward;
- a 3-step `train_loop` with its CSV, checkpoint and resume, and `main()`.
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
from openpose_plus_tpu.data.targets import make_targets_batch
from openpose_plus_tpu.engine import preprocess_images as jpreprocess
from openpose_plus_tpu.models import get_model as jget_model
from openpose_plus_tpu_torch import checkpoint as ckpt
from openpose_plus_tpu_torch import train as T
from openpose_plus_tpu_torch.config import default_config
from openpose_plus_tpu_torch.data.targets import make_targets
from openpose_plus_tpu_torch.engine import preprocess_images

from tests.test_train import _write_fake_dataset

torch.set_num_threads(2)

MODELS = ["vggtiny", "hao28", "mobilenet_thin"]


def _configs(name="vggtiny", batch=2, **train):
    """The same tiny float32 config in both packages."""
    kw = dict(hin=64, win=64, n_stages=2, compute_dtype="float32")
    tr = {"batch_size": batch, "lr_init": 3e-4, "weight_decay": 0.0,
          **train}
    out = []
    for dc in (jdefault_config, default_config):
        cfg = dc(name)
        out.append(cfg.replace(
            model=dataclasses.replace(cfg.model, **kw),
            train=dataclasses.replace(cfg.train, **tr)))
    return out


def _batch(cfg, seed=0):
    """A pipeline-shaped batch: two people per image (one with hidden
    parts), a loss mask with a hole."""
    rng = np.random.default_rng(seed)
    b, m = cfg.train.batch_size, cfg.model
    kp = np.zeros((b, 3, 18, 3), np.float32)
    kp[:, :2, :, 0] = rng.uniform(3, m.win - 3, (b, 2, 18))
    kp[:, :2, :, 1] = rng.uniform(3, m.hin - 3, (b, 2, 18))
    kp[:, :2, :, 2] = rng.uniform(0, 1, (b, 2, 18)) < 0.8
    mask = np.ones((b, m.hout, m.wout, 1), np.float32)
    mask[:, 1:4, 2:6] = 0.0
    return {"images": rng.integers(0, 256, (b, m.hin, m.win, 3),
                                   dtype=np.uint8),
            "keypoints": kp, "mask": mask}


def _jax_state(jcfg, seed=0):
    """JT.create_train_state with the Flax init jitted (eager init takes
    seconds a model)."""
    m = jcfg.model.train_lowering()
    params = jax.jit(jget_model(m).init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, m.hin, m.win, 3)))
    tx = JT.make_optimizer(jcfg.train, m.hout * m.wout)
    return JT.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                         opt_state=tx.init(params))


def _port_state(jcfg, cfg):
    """A JAX train state and a port state on the same (bridged) params."""
    jstate = _jax_state(jcfg)
    state = T.create_train_state(cfg, device="cpu")
    state.model.load_state_dict(ckpt.from_flax(
        jckpt._flatten(jax.device_get(jstate.params))))
    return jstate, state


def _as_torch(jparams):
    return ckpt.from_flax(jckpt._flatten(jax.device_get(jparams)))


def _jax_targets(jcfg, batch):
    images = jpreprocess(jnp.asarray(batch["images"]))
    gt_conf, gt_paf = make_targets_batch(jnp.asarray(batch["keypoints"]),
                                         jcfg.model, jcfg.data)
    return images, gt_conf, gt_paf, jnp.asarray(batch["mask"])


def _port_targets(cfg, batch):
    m, d = cfg.model, cfg.data
    gt_conf, gt_paf = make_targets(torch.from_numpy(batch["keypoints"]),
                                   m.hout, m.wout, m.stride, d.sigma,
                                   d.limb_width)
    return (preprocess_images(torch.from_numpy(batch["images"])), gt_conf,
            gt_paf, torch.from_numpy(batch["mask"]))


def _assert_params_close(state, jparams, atol, what):
    ref = _as_torch(jparams)
    out = state.model.state_dict()
    assert out.keys() == ref.keys()
    for name, r in ref.items():
        np.testing.assert_allclose(out[name].numpy(), r.numpy(), rtol=0,
                                   atol=atol, err_msg=f"{what} {name}")


# ------------------------------------------------------- loss, schedule ---

@pytest.mark.parametrize("with_mask", [False, True])
def test_pose_loss_matches_jax(with_mask):
    rng = np.random.default_rng(1)
    b, h, w = 3, 8, 10
    outs = {k: [rng.normal(0, 1, (b, h, w, c)).astype(np.float32)
                for _ in range(3)] for k, c in (("conf", 19), ("paf", 38))}
    gt_conf = rng.uniform(0, 1, (b, h, w, 19)).astype(np.float32)
    gt_paf = rng.uniform(-1, 1, (b, h, w, 38)).astype(np.float32)
    mask = (rng.uniform(0, 1, (b, h, w, 1)) < 0.7).astype(np.float32)
    ref, ref_m = JT.pose_loss(
        {k: [jnp.asarray(x) for x in v] for k, v in outs.items()},
        jnp.asarray(gt_conf), jnp.asarray(gt_paf),
        jnp.asarray(mask) if with_mask else None)
    out, out_m = T.pose_loss(
        {k: [torch.from_numpy(x) for x in v] for k, v in outs.items()},
        torch.from_numpy(gt_conf), torch.from_numpy(gt_paf),
        torch.from_numpy(mask) if with_mask else None)
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)
    for key in ("loss_conf_last", "loss_paf_last"):
        np.testing.assert_allclose(float(out_m[key]), float(ref_m[key]),
                                   rtol=1e-6)
    assert out.dtype == torch.float32


def test_pose_loss_casts_bf16_stages_to_float32():
    """bf16 stage outputs are cast to float32 before the subtraction, as
    the reference's `astype(float32)`."""
    rng = np.random.default_rng(2)
    pred = rng.normal(0, 1, (2, 4, 5, 19)).astype(np.float32)
    gt = rng.uniform(0, 1, (2, 4, 5, 19)).astype(np.float32)
    paf = np.zeros((2, 4, 5, 38), np.float32)
    bf = torch.from_numpy(pred).to(torch.bfloat16)
    ref, _ = JT.pose_loss({"conf": [jnp.asarray(pred, jnp.bfloat16)],
                           "paf": [jnp.asarray(paf)]},
                          jnp.asarray(gt), jnp.asarray(paf))
    out, _ = T.pose_loss({"conf": [bf], "paf": [torch.from_numpy(paf)]},
                         torch.from_numpy(gt), torch.from_numpy(paf))
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)


@pytest.mark.parametrize("lr_scaling,area", [
    ("none", None), ("none", 64), ("inv-sqrt-area", 256),
    ("inv-sqrt-area", 46 * 54), ("inv-sqrt-area", None)])
def test_effective_lr_init_matches_jax(lr_scaling, area):
    jcfg, cfg = (dataclasses.replace(c.train, lr_init=1e-3,
                                     lr_scaling=lr_scaling)
                 for c in _configs())
    assert T.effective_lr_init(cfg, area) == JT.effective_lr_init(jcfg, area)
    bogus = dataclasses.replace(cfg, lr_scaling="bogus")
    with pytest.raises(ValueError, match="lr_scaling"):
        T.effective_lr_init(bogus, 100)


def _assert_f32_ulp(out, ref):
    np.testing.assert_array_max_ulp(np.float32(out), np.float32(ref), 1)


@pytest.mark.parametrize("every,factor,area", [
    (3, 0.333, None), (136_120, 0.333, None), (5, 0.5, 46 * 54)])
def test_lr_schedule_matches_jax(every, factor, area):
    """The staircase at and around every decay boundary: the schedule
    function, and the lr the LambdaLR hands the optimizer at each step (the
    schedule at the step's pre-increment count, as optax reads it). optax
    evaluates the power in float32, the port in float64: the port's value
    rounded to float32 is within 1 float32 ulp of optax's."""
    jcfg, cfg = (dataclasses.replace(
        c.train, lr_init=1e-3, lr_decay_every=every, lr_decay_factor=factor,
        lr_scaling="inv-sqrt-area" if area else "none") for c in _configs())
    ref, out = JT.lr_schedule(jcfg, area), T.lr_schedule(cfg, area)
    counts = sorted({c for k in range(4) for c in (k * every - 1,
                                                   k * every,
                                                   k * every + 1)
                     if c >= 0})
    for c in counts:
        _assert_f32_ulp(out(c), ref(c))
    opt, sched = T.make_optimizer(cfg, torch.nn.Linear(2, 2), area)
    for c in range(min(3 * every + 2, 40)):
        _assert_f32_ulp(opt.param_groups[0]["lr"], ref(c))
        assert opt.param_groups[1]["lr"] == opt.param_groups[0]["lr"]
        opt.step()
        sched.step()


def test_optimizer_groups_and_choices():
    _, cfg = _configs(weight_decay=5e-4)
    model = torch.nn.Conv2d(3, 4, 3)
    opt, _ = T.make_optimizer(cfg.train, model)
    assert isinstance(opt, torch.optim.Adam)
    (kern, kwd), (bias, bwd) = ((g["params"], g["weight_decay"])
                                for g in opt.param_groups)
    assert [p.ndim for p in kern] == [4] and kwd == 5e-4
    assert [p.ndim for p in bias] == [1] and bwd == 0.0
    assert opt.defaults["betas"] == (0.9, 0.999)
    assert opt.defaults["eps"] == 1e-8
    mom = dataclasses.replace(cfg.train, optimizer="momentum")
    sgd, _ = T.make_optimizer(mom, model)
    assert isinstance(sgd, torch.optim.SGD)
    assert (sgd.defaults["momentum"], sgd.defaults["dampening"],
            sgd.defaults["nesterov"]) == (0.9, 0.0, False)
    with pytest.raises(ValueError, match="optimizer"):
        T.make_optimizer(dataclasses.replace(cfg.train, optimizer="rms"),
                         model)


# ------------------------------------------------------------ train step ---

_JAX_GRADS = {}


def _jax_loss_and_grads(jcfg, jparams, batch):
    """The reference's loss and gradients at jparams (jitted per model)."""
    key = jcfg.model.name
    if key not in _JAX_GRADS:
        model = jget_model(jcfg.model.train_lowering())

        def loss_fn(params, images, gt_conf, gt_paf, mask):
            return JT.pose_loss(model.apply(params, images), gt_conf,
                                gt_paf, mask)

        _JAX_GRADS[key] = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (loss, _), grads = _JAX_GRADS[key](jparams, *_jax_targets(jcfg, batch))
    return float(loss), _as_torch(grads)


def _assert_grads_close(model, ref_grads):
    """Each gradient within 1e-4 of its leaf's largest magnitude."""
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert grads.keys() == ref_grads.keys()
    for name, r in ref_grads.items():
        scale = float(r.abs().max())
        np.testing.assert_allclose(grads[name].numpy(), r.numpy(), rtol=0,
                                   atol=1e-4 * scale + 1e-30, err_msg=name)


@pytest.mark.parametrize("name", MODELS)
def test_train_step_matches_jax(name):
    """make_train_step, Adam with weight decay and a decay boundary at step
    2: each step's loss and lr, step 1's gradients, then the parameters
    after 3 steps. Adam divides each gradient by its own running RMS, so
    where a gradient is near zero or changes sign between steps (half of
    these tiny models' gradients are exactly zero, dead ReLU units) the
    float32 differences of the two packages' gradients decide the step;
    such elements may then differ by a few steps' size (lr = 3e-4; bound
    2e-3), and their differences feed the next steps' gradients. Measured
    1-3% of the elements; 95% of them must agree within 2e-6, which a
    wrong update rule (it moves every element) cannot."""
    jcfg, cfg = _configs(name, weight_decay=5e-4, lr_decay_every=2,
                         lr_decay_factor=0.5)
    jstate, state = _port_state(jcfg, cfg)
    batch = _batch(cfg)
    ref_loss, ref_grads = _jax_loss_and_grads(jcfg, jstate.params, batch)
    jstep, step = JT.make_train_step(jcfg), T.make_train_step(cfg)
    jargs, args = _jax_targets(jcfg, batch), _port_targets(cfg, batch)
    for i in range(3):
        jstate, jm = jstep(jstate, *jargs)
        state, m = step(state, *args)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        _assert_f32_ulp(m["lr"], jm["lr"])
        if i == 0:
            np.testing.assert_allclose(float(m["loss"]), ref_loss,
                                       rtol=1e-5)
            _assert_grads_close(state.model, ref_grads)
    assert state.step == int(jstate.step) == 3
    _assert_params_close(state, jstate.params, 2e-3, "after 3 Adam steps")
    ref, out = _as_torch(jstate.params), state.model.state_dict()
    diff = torch.cat([(out[n] - r).abs().flatten() for n, r in ref.items()])
    assert float((diff <= 2e-6).float().mean()) >= 0.95


@pytest.mark.parametrize("name", MODELS)
def test_train_step_on_batch_matches_jax(name):
    """make_train_step_on_batch (GT synthesised in the step), momentum SGD
    with weight decay: the loss and its branch terms at each of 3 steps and
    the parameters after them. Momentum is linear in the gradients, so the
    parameters agree to float32 rounding (1e-6 absolute)."""
    jcfg, cfg = _configs(name, optimizer="momentum", weight_decay=5e-4,
                         lr_init=1e-2)
    jstate, state = _port_state(jcfg, cfg)
    jstep = JT.make_train_step_on_batch(jcfg)
    step = T.make_train_step_on_batch(cfg)
    for i in range(3):
        batch = _batch(cfg, seed=i)
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, batch)
        for key in ("loss", "loss_conf_last", "loss_paf_last"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=key)
    _assert_params_close(state, jstate.params, 1e-6, "after 3 momentum steps")


def test_train_step_takes_every_input_layout():
    """The batch step accepts the s2d and s2d^2 layouts Engine accepts and
    computes the same step as on the plain images."""
    from openpose_plus_tpu_torch.models.common import space_to_depth

    _, cfg = _configs("mobilenet_thin")
    batch = _batch(cfg)
    plain = torch.from_numpy(batch["images"])
    losses = []
    for images in (plain, space_to_depth(plain),
                   space_to_depth(space_to_depth(plain))):
        state = T.create_train_state(cfg, device="cpu")
        _, m = T.make_train_step_on_batch(cfg)(state, dict(batch,
                                                           images=images))
        losses.append(float(m["loss"]))
    assert losses[0] == losses[1] == losses[2]


def test_bf16_step_gradients_near_float32(capsys):
    """One full-width MobileNet-thin step (368x432, batch 2) in bfloat16
    against float32, on the CPU, from the same seeded parameters: the gap
    that chip_smoke.py's card-vs-CPU tolerances (TRAIN_LEAF_RTOL,
    TRAIN_ALL_RTOL) are set from — bf16 rounds every activation, and the
    card's and the CPU's roundings differ independently."""
    cfg = default_config("mobilenet_thin")
    m = cfg.model
    rng = np.random.default_rng(0)
    kp = np.zeros((2, 4, 18, 3), np.float32)
    kp[..., 0] = rng.uniform(30, m.win - 30, (2, 4, 18))
    kp[..., 1] = rng.uniform(30, m.hin - 30, (2, 4, 18))
    kp[..., 2] = 1.0
    batch = {"images": rng.integers(0, 256, (2, m.hin, m.win, 3),
                                    dtype=np.uint8),
             "keypoints": kp, "mask": np.ones((2, m.hout, m.wout, 1),
                                              np.float32)}
    grads = {}
    for dtype in ("float32", "bfloat16"):
        c = cfg.replace(model=dataclasses.replace(m, compute_dtype=dtype))
        state = T.create_train_state(c, device="cpu")
        T.make_train_step_on_batch(c)(state, batch)
        grads[dtype] = {n: p.grad for n, p in state.model.named_parameters()}
    ref, out = grads["float32"], grads["bfloat16"]
    leaf = sorted(float((out[n] - g).norm() / g.norm()) for n, g in ref.items())
    every = float(torch.cat([(out[n] - g).flatten() for n, g in ref.items()])
                  .norm() / torch.cat([g.flatten() for g in ref.values()])
                  .norm())
    with capsys.disabled():
        print(f"\nbf16 vs float32 step gradients, relative L2: median leaf "
              f"{leaf[len(leaf) // 2]:.4f}, worst leaf {leaf[-1]:.4f}, all "
              f"{every:.4f}")
    assert leaf[-1] < 0.15 and every < 5e-2


def test_remat_stages_same_gradients():
    _, cfg = _configs("mobilenet_thin")
    batch = _batch(cfg)
    grads = []
    for remat in (False, True):
        c = cfg.replace(model=dataclasses.replace(cfg.model,
                                                  remat_stages=remat))
        state = T.create_train_state(c, seed=3, device="cpu")
        assert state.model.stages.remat is remat
        T.make_train_step(c)(state, *_port_targets(c, batch))
        grads.append({n: p.grad for n, p in state.model.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=0, atol=0)


def test_refusals():
    _, cfg = _configs("mobilenet_thin")
    for model_kw, match in (({"compute_dtype": "int8"}, "int8"),
                            ({"fused_inference": True}, "fused_inference")):
        bad = cfg.replace(model=dataclasses.replace(cfg.model, **model_kw))
        for fn in (lambda: T.create_train_state(bad, device="cpu"),
                   lambda: T.make_train_step(bad),
                   lambda: T.make_train_step_on_batch(bad)):
            with pytest.raises(ValueError, match=match):
                fn()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.create_train_state(cfg)


@pytest.mark.parametrize("change", [
    {"train": {"kf_optimizer": "sma"}},
    {"train": {"kf_optimizer": "pair-avg"}},
    {"parallel": {"multihost": True}},
    {"parallel": {"spatial_parallelism": 2}}], ids=str)
def test_distributed_strategies_raise(change, tmp_path, monkeypatch):
    """train_loop on a world of one, as the reference on one device: sma
    trains; pair-avg raises the reference's power-of-two error; multihost
    starts a gloo group of one from torchrun's environment and trains; a
    spatial axis of 2 raises the reference's mesh error, one device not
    being divisible by 2 (tests/test_torch_parallel.py runs the strategies
    on 2 and 4 ranks, tests/test_torch_spatial.py the spatial axis)."""
    import torch.distributed as dist

    from tests.torch_ranks import free_port

    cfg = _loop_config(tmp_path)
    cfg = cfg.replace(**{section: dataclasses.replace(getattr(cfg, section),
                                                      **kw)
                         for section, kw in change.items()})
    if cfg.parallel.spatial_parallelism > 1:
        with pytest.raises(ValueError,
                           match="^1 devices not divisible by spatial=2$"):
            T.train_loop(cfg, n_steps=1, device="cpu")
        return
    if cfg.train.kf_optimizer == "pair-avg":
        with pytest.raises(ValueError,
                           match="power-of-two device count, got 1"):
            T.train_loop(cfg, n_steps=1, device="cpu")
        return
    for key, value in (("MASTER_ADDR", "127.0.0.1"),
                       ("MASTER_PORT", str(free_port())), ("RANK", "0"),
                       ("LOCAL_RANK", "0"), ("WORLD_SIZE", "1")):
        monkeypatch.setenv(key, value)
    try:
        state = T.train_loop(cfg, n_steps=1, log=lambda _: None,
                             device="cpu")
        assert state.step == 1
        assert dist.is_initialized() == cfg.parallel.multihost
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ----------------------------------------------------------- checkpoints ---

def test_checkpoint_save_restore_keep(tmp_path):
    """One directory a step, the newest 3 kept, atomic (no temporary
    left), restore into a fresh state gives the model, optimizer and
    schedule back."""
    _, cfg = _configs(lr_decay_every=2, lr_decay_factor=0.5)
    state = T.create_train_state(cfg, device="cpu")
    step = T.make_train_step(cfg)
    args = _port_targets(cfg, _batch(cfg))
    path = str(tmp_path / "ck")
    assert ckpt.latest_step(path) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(path, state)
    for _ in range(5):
        state, _ = step(state, *args)
        ckpt.save(path, state, state.step, keep=3)
    assert ckpt.latest_step(path) == 5
    assert sorted(os.listdir(path)) == ["3", "4", "5"]
    fresh = ckpt.restore(path, T.create_train_state(cfg, seed=9,
                                                    device="cpu"))
    assert fresh.step == 5 and fresh.scheduler.last_epoch == 5
    for a, b in zip(fresh.model.state_dict().values(),
                    state.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert fresh.optimizer.param_groups[0]["lr"] == \
        state.optimizer.param_groups[0]["lr"]
    # the next step from the restored state is the original's
    _, m1 = step(fresh, *args)
    _, m2 = step(state, *args)
    assert float(m1["loss"]) == float(m2["loss"])
    older = ckpt.restore(path, T.create_train_state(cfg, device="cpu"),
                         step=3)
    assert older.step == 3


def test_save_npz_loads_in_jax(tmp_path):
    """Port-trained weights -> the JAX flat npz -> the JAX package's
    load_npz: the same forward in both packages."""
    jcfg, cfg = _configs("mobilenet_thin")
    state = T.create_train_state(cfg, seed=5, device="cpu")
    T.make_train_step(cfg)(state, *_port_targets(cfg, _batch(cfg)))
    path = ckpt.save_npz(str(tmp_path / "w"), state.model.state_dict())
    assert path.endswith("w.npz") and os.path.exists(path)
    jparams = jckpt.load_npz(path, _jax_state(jcfg, seed=1).params)
    images = _batch(cfg)["images"]
    ref = jax.jit(jget_model(jcfg.model).apply)(jparams, jpreprocess(
        jnp.asarray(images)))
    state.model.eval()
    with torch.no_grad():
        out = state.model(preprocess_images(torch.from_numpy(images)))
    for key in ("conf", "paf"):
        for o, r in zip(out[key], ref[key]):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                       atol=1e-4 * float(np.abs(r).max()))
    # and back through the bridge
    back = ckpt.from_flax(ckpt.load_npz(path))
    for name, t in state.model.state_dict().items():
        torch.testing.assert_close(back[name], t, rtol=0, atol=0)


# ------------------------------------------------------------- the loop ---

def _loop_config(tmp_path, name="vggtiny"):
    ann, imgs = _write_fake_dataset(tmp_path)
    _, cfg = _configs(name, batch=4)
    return cfg.replace(
        data=dataclasses.replace(cfg.data, train_annotations=ann,
                                 train_images=imgs, num_workers=1,
                                 prefetch=2),
        train=dataclasses.replace(cfg.train, log_every=2, checkpoint_every=3,
                                  checkpoint_dir=str(tmp_path / "ck"),
                                  metrics_csv=str(tmp_path / "metrics.csv"),
                                  vis_every=3, vis_dir=str(tmp_path / "vis")))


def test_train_loop_end_to_end(tmp_path):
    """3 real steps through the pipeline, the loop, the CSV, a checkpoint
    and a heatmap dump on fake data, then a resume, as
    tests/test_train.py::test_train_loop_end_to_end."""
    cfg = _loop_config(tmp_path)
    logs = []
    state = T.train_loop(cfg, n_steps=3, log=logs.append, device="cpu")
    assert state.step == 3
    assert ckpt.latest_step(str(tmp_path / "ck")) == 3
    line = next(l for l in logs if l.startswith("step 2 "))
    assert " loss " in line and " lr 3.00e-04 " in line
    assert line.endswith(" img/s")
    rows = open(tmp_path / "metrics.csv").read().strip().splitlines()
    assert rows[0] == ("step,loss,loss_conf_last,loss_paf_last,lr,"
                       "imgs_per_sec")
    assert len(rows) == 2 and rows[1].startswith("2,")
    assert np.isfinite([float(v) for v in rows[1].split(",")]).all()
    assert sorted(os.listdir(tmp_path / "vis")) == ["step3_gt.jpg",
                                                    "step3_pred.jpg"]
    state2 = T.train_loop(cfg, n_steps=5, log=logs.append, device="cpu")
    assert state2.step == 5
    assert "resumed from step 3" in logs
    rows = open(tmp_path / "metrics.csv").read().strip().splitlines()
    assert [r.split(",")[0] for r in rows[1:]] == ["2", "4"]


def test_main_on_the_cpu(tmp_path):
    ann, imgs = _write_fake_dataset(tmp_path)
    ck, csv = str(tmp_path / "ck"), str(tmp_path / "m.csv")
    T.main(["--model", "mobilenet_thin", "--steps", "1", "--batch-size", "1",
            "--train-images", imgs, "--train-annotations", ann,
            "--checkpoint-dir", ck, "--metrics-csv", csv,
            "--device", "cpu"])
    assert os.path.exists(csv)
    ck_sma = str(tmp_path / "ck_sma")
    T.main(["--model", "mobilenet_thin", "--steps", "1", "--batch-size", "1",
            "--train-images", imgs, "--train-annotations", ann,
            "--checkpoint-dir", ck_sma, "--checkpoint-every", "1",
            "--kf-optimizer", "sma", "--device", "cpu"])
    assert ckpt.latest_step(ck_sma) == 1
