"""PyTorch port: ``train/optim.py`` and ``ops/losses.py`` against optax and
the JAX package: the learning rate at every update, Adam, AdamW and
Adafactor step for step, global-norm clipping, and the fp32 loss and
metric primitives.

Tolerances: 1e-6 (fp32 arithmetic in another order; optax evaluates its
schedules in fp32)."""

import math

import numpy as np
import pytest
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch import config as t_config
from huggingface_sagemaker_tensorflow_distributed_tpu_torch.train import optim as t_optim


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one intra-op thread per test worker runs
    them faster than a pool contending with the other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True, scope="module")
def _detached_compile_trackers():
    """A compile tracker that an earlier telemetry test installed in this
    worker rejects the ``fun_name`` keyword jax 0.9 passes to duration
    listeners, failing every later jax compile in the worker. Remove every
    installed tracker before and after this module, leaving the worker as a
    fresh one would be (a later telemetry test installs its own). (The
    card's machine runs the ``gpu`` tests without JAX: nothing to remove.)"""
    _drop_compile_trackers()
    yield
    _drop_compile_trackers()


def _drop_compile_trackers():
    try:
        from jax import monitoring

        from huggingface_sagemaker_tensorflow_distributed_tpu.obs import watchdog
    except ImportError:
        return
    for tracker in watchdog._INSTALLED:
        try:
            monitoring.unregister_event_duration_listener(tracker.observe)
        except AssertionError:
            pass
    watchdog._INSTALLED.clear()


# -- optimizer ---------------------------------------------------------------

def _optax_schedule(kind, lr, warmup, updates):
    import optax

    if kind == "cosine":
        return optax.schedules.warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=lr, warmup_steps=warmup, decay_steps=updates,
            end_value=0.0)
    # optax's warmup + linear decay: what the JAX package's
    # ``warmup_linear_decay_schedule`` call composes
    return optax.join_schedules([optax.linear_schedule(0.0, lr, warmup),
                                 optax.linear_schedule(lr, 0.0, updates - warmup)],
                                [warmup])


@pytest.mark.parametrize("kind", ["linear", "cosine"])
@pytest.mark.parametrize("accum", [1, 3])
def test_lr_schedule_matches_optax(kind, accum):
    cfg = t_config.TrainConfig(learning_rate=2e-4, warmup_ratio=0.15, lr_schedule=kind,
                               gradient_accumulation_steps=accum)
    total = 61
    schedule, lr = t_optim.lr_schedule(cfg, world_size=4, total_steps=total)
    assert lr == pytest.approx(8e-4)
    updates = max(1, total // accum)
    warmup = max(1, int(updates * 0.15))
    want = _optax_schedule(kind, lr, warmup, updates)
    for n in range(updates + 3):
        # optax evaluates in fp32: 1e-6 of the peak absolute
        assert schedule(n) == pytest.approx(float(want(n)), rel=1e-6, abs=1e-6 * lr), n
    flat, _ = t_optim.lr_schedule(t_config.TrainConfig(scale_lr_by_world_size=False),
                                  world_size=4, total_steps=total)
    assert flat(0) == flat(50) == 5e-5


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adam_and_adamw_match_optax(wd):
    """optax's adamw (``-lr * (adam + wd * p)``) is torch's decoupled AdamW,
    and optax's adam is torch's Adam, step for step."""
    import jax.numpy as jnp
    import optax

    rng = np.random.RandomState(1)
    p0 = [rng.randn(4, 3).astype(np.float32), rng.randn(5).astype(np.float32)]
    grads = [[rng.randn(*p.shape).astype(np.float32) for p in p0] for _ in range(4)]
    cfg = t_config.TrainConfig(optimizer="adamw", weight_decay=wd, learning_rate=1e-2)
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt, schedule, _ = t_optim.build_optimizer(cfg, params)
    assert isinstance(opt, torch.optim.AdamW if wd else torch.optim.Adam)
    tx = optax.adamw(1e-2, weight_decay=wd) if wd else optax.adam(1e-2)
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    for g in grads:
        for p, gi in zip(params, g):
            p.grad = torch.from_numpy(gi)
        opt.step()
        upd, state = tx.update([jnp.asarray(gi) for gi in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, w in zip(params, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_optax(max_norm):
    import jax.numpy as jnp
    import optax

    rng = np.random.RandomState(2)
    gs = [rng.randn(3, 4).astype(np.float32), rng.randn(6).astype(np.float32)]
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in gs]
    for p, g in zip(params, gs):
        p.grad = torch.from_numpy(g.copy())
    norm = t_optim.clip_by_global_norm(params, max_norm)
    want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in gs], None)
    np.testing.assert_allclose(norm.item(), math.sqrt(sum((g ** 2).sum() for g in gs)),
                               rtol=1e-6)
    for p, w in zip(params, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


ADAFACTOR_SHAPES = [(256, 128), (130, 300), (64, 100), (200,), (128, 128), (2, 130, 140)]


@pytest.mark.parametrize("schedule", ["constant", "warmup_linear"])
@pytest.mark.parametrize("max_norm", [1.0, 0.0], ids=["clipped", "unclipped"])
def test_adafactor_matches_optax(schedule, max_norm):
    """Ten steps of the trainer's update order (global-norm clipping, then
    the optimizer at the schedule's learning rate) against
    ``optax.chain(clip_by_global_norm, adafactor(schedule))`` within 1e-6
    relative: factored ([256, 128], the ragged [130, 300], the square
    [128, 128], the 3-axis [2, 130, 140]) and unfactored ([64, 100],
    [200]) parameters, gradients growing step by step so the block-RMS
    clip acts."""
    import jax.numpy as jnp
    import optax

    rng = np.random.RandomState(3)
    p0 = [(rng.randn(*s) * 0.05).astype(np.float32) for s in ADAFACTOR_SHAPES]
    grads = [[(rng.randn(*s) * (0.1 + k)).astype(np.float32) for s in ADAFACTOR_SHAPES]
             for k in range(10)]
    cfg = t_config.TrainConfig(optimizer="adafactor", weight_decay=0.0, learning_rate=1e-2,
                               warmup_ratio=0.3 if schedule != "constant" else 0.0,
                               max_grad_norm=max_norm, scale_lr_by_world_size=False)
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt, sched, _ = t_optim.build_optimizer(cfg, params, total_steps=10)
    assert isinstance(opt, t_optim.Adafactor)
    lr = 1e-2 if schedule == "constant" else _optax_schedule("linear", 1e-2, 3, 10)
    chain = [optax.clip_by_global_norm(max_norm)] if max_norm else []
    tx = optax.chain(*chain, optax.adafactor(lr))
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    for n, g in enumerate(grads):
        for p, gi in zip(params, g):
            p.grad = torch.from_numpy(gi.copy())
        if max_norm:
            t_optim.clip_by_global_norm(params, max_norm)
        t_optim.set_lr(opt, sched(n))
        opt.step()
        upd, state = tx.update([jnp.asarray(gi) for gi in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, w in zip(params, jp):
            w = np.asarray(w)
            err = np.abs(p.detach().numpy() - w).max() / np.abs(w).max()
            assert err <= 1e-6, (n, p.shape, err)
    factored = [t_optim.factored_dims(s) for s in ADAFACTOR_SHAPES]
    assert factored == [(1, 0), (0, 1), None, None, (0, 1), (1, 2)]
    assert opt.state[params[0]]["step"] == 10 and "v" in opt.state[params[2]]


def test_adafactor_state_round_trips_through_state_dict():
    """The factored moments and the step count are in ``state_dict()``
    (the checkpoint's), and a fresh optimizer loaded from it takes the
    same next step."""
    rng = np.random.RandomState(4)
    shapes = [(256, 128), (40,)]
    p0 = [rng.randn(*s).astype(np.float32) for s in shapes]

    def make():
        ps = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
        return ps, t_optim.Adafactor(ps, lr=1e-2)

    a, opt_a = make()
    for _ in range(3):
        for p in a:
            p.grad = torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
        opt_a.step()
    b, opt_b = make()
    with torch.no_grad():
        for pa, pb in zip(a, b):
            pb.copy_(pa)
    opt_b.load_state_dict(opt_a.state_dict())
    assert set(opt_a.state_dict()["state"][0]) == {"step", "v_row", "v_col"}
    g = [torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in shapes]
    for ps, opt in ((a, opt_a), (b, opt_b)):
        for p, gi in zip(ps, g):
            p.grad = gi.clone()
        opt.step()
    for pa, pb in zip(a, b):
        assert torch.equal(pa, pb)


def test_losses_match_jax():
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.ops import losses as j_losses
    from huggingface_sagemaker_tensorflow_distributed_tpu_torch.ops import losses as t_losses

    rng = np.random.RandomState(3)
    logits = (rng.randn(6, 3) * 4).astype(np.float32)
    labels = rng.randint(0, 3, 6).astype(np.int32)
    valid = np.array([1, 1, 0, 1, 0, 1], np.float32)
    np.testing.assert_allclose(
        t_losses.softmax_cross_entropy_with_integer_labels(
            torch.from_numpy(logits), torch.from_numpy(labels)).numpy(),
        np.asarray(j_losses.softmax_cross_entropy_with_integer_labels(
            jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6, atol=1e-6)
    for mask in (None, valid, np.zeros(6, np.float32)):
        tm = None if mask is None else torch.from_numpy(mask)
        jm = None if mask is None else jnp.asarray(mask)
        assert t_losses.accuracy(torch.from_numpy(logits), torch.from_numpy(labels),
                                 tm).item() == pytest.approx(float(j_losses.accuracy(
                                     jnp.asarray(logits), jnp.asarray(labels), jm)))
        assert t_losses.masked_mean(torch.from_numpy(logits[:, 0]), tm).item() == \
            pytest.approx(float(j_losses.masked_mean(jnp.asarray(logits[:, 0]), jm)),
                          rel=1e-6)
