"""PyTorch port: ``train/optim.py`` and ``ops/losses.py`` against optax and
the JAX package: the learning rate at every update, Adam, AdamW,
Adafactor, LAMB and the bf16-moment Adam step for step, global-norm
clipping, and the fp32 loss and metric primitives.

Tolerances: 1e-6 (fp32 arithmetic in another order; optax evaluates its
schedules in fp32); stored bf16 moments within one bf16 ulp (two fp32 sums
in another order may round to neighbouring bf16 values)."""

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



# -- LAMB and bf16 moments (ROADMAP item 4) ---------------------------------

# a [64, 48] matrix, a ragged one, a bias, a zero-initialized bias (its
# parameter norm is 0 at the first step: trust ratio 1) and a 3-axis tensor
ITEM4_SHAPES = [(64, 48), (33, 17), (48,), (17,), (2, 5, 7)]


def _item4_case(seed: int, accum: int):
    rng = np.random.RandomState(seed)
    p0 = [(rng.randn(*s) * 0.1).astype(np.float32) for s in ITEM4_SHAPES]
    p0[3][:] = 0.0
    # 5 updates of ``accum`` micro-batch gradients each, growing so the
    # clip acts on the later ones
    grads = [[[(rng.randn(*s) * (0.2 + 0.5 * k)).astype(np.float32) for s in ITEM4_SHAPES]
              for _ in range(accum)] for k in range(5)]
    return p0, grads


def _jax_adam_state(state):
    """The ``ScaleByAdamState`` inside a JAX optimizer state tree."""
    if hasattr(state, "mu") and hasattr(state, "nu"):
        return state
    if isinstance(state, tuple):
        for part in state:
            found = _jax_adam_state(part)
            if found is not None:
                return found
    for name in ("inner_opt_state",):
        if hasattr(state, name):
            return _jax_adam_state(getattr(state, name))
    return None


def _run_item4(cfg_kw: dict, accum: int, seed: int):
    """The port's trainer update order (micro-batch gradients summed over
    ``accum`` as ``loss / accum`` gives them, the global-norm clip, the
    schedule's learning rate, the step) against the JAX package's
    ``build_optimizer`` (``MultiSteps`` over clip and the optimizer) on the
    same inputs. Returns the port's parameters and optimizer and the JAX
    parameters and state after each update."""
    import jax.numpy as jnp
    import optax

    from huggingface_sagemaker_tensorflow_distributed_tpu.config import TrainConfig
    from huggingface_sagemaker_tensorflow_distributed_tpu.train.optim import build_optimizer

    kw = dict(learning_rate=2e-2, scale_lr_by_world_size=False,
              gradient_accumulation_steps=accum, **cfg_kw)
    p0, grads = _item4_case(seed, accum)
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt, sched, _ = t_optim.build_optimizer(t_config.TrainConfig(**kw), params)
    tx, _ = build_optimizer(TrainConfig(**kw))
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    steps = []
    for n, micro in enumerate(grads):
        for p in params:
            p.grad = None
        for g in micro:
            for p, gi in zip(params, g):
                add = torch.from_numpy(gi / accum if accum > 1 else gi.copy())
                p.grad = add if p.grad is None else p.grad + add
            upd, state = tx.update([jnp.asarray(gi) for gi in g], state, jp)
            jp = optax.apply_updates(jp, upd)
        if kw.get("max_grad_norm", 0) > 0:
            t_optim.clip_by_global_norm(params, kw["max_grad_norm"])
        t_optim.set_lr(opt, sched(n))
        opt.step()
        steps.append(([p.detach().clone() for p in params], [np.asarray(w) for w in jp],
                      state))
    return params, opt, steps


def _rel_err(got: torch.Tensor, want: np.ndarray) -> float:
    return float(np.abs(got.numpy() - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("wd", [0.0, 0.01], ids=["no_decay", "decay"])
@pytest.mark.parametrize("mode", ["plain", "clipped", "accumulated"])
def test_lamb_matches_optax(wd, mode):
    """Five LAMB updates against ``optax.lamb(lr, weight_decay=wd)`` as the
    JAX package chains it (global-norm clip 0.5 first; ``MultiSteps`` over
    3 micro-batches): every parameter within 1e-6 relative after every
    update, the zero bias included (its trust ratio is 1 at the first
    step, where its norm is 0)."""
    cfg = dict(optimizer="lamb", weight_decay=wd,
               max_grad_norm=0.5 if mode == "clipped" else 0.0)
    params, opt, steps = _run_item4(cfg, 3 if mode == "accumulated" else 1, seed=5)
    assert isinstance(opt, t_optim.Lamb)
    for n, (got, want, _) in enumerate(steps):
        for g, w, shape in zip(got, want, ITEM4_SHAPES):
            assert _rel_err(g, w) <= 1e-6, (n, shape, _rel_err(g, w))
    st = opt.state[params[0]]
    assert st["step"] == 5 and st["exp_avg"].dtype == torch.float32
    assert opt.defaults["eps"] == 1e-6


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at ``|x|`` (8 significant bits), 0 where ``x`` is 0."""
    mag = np.abs(x.astype(np.float64))
    exp = np.floor(np.log2(np.where(mag > 0, mag, 1.0)))
    return np.where(mag > 0, 2.0 ** (exp - 7), 0.0)


@pytest.mark.parametrize("optimizer,wd,clip", [("adam", 0.0, 0.0), ("adamw", 0.01, 0.0),
                                              ("adamw", 0.01, 0.5)],
                         ids=["adam", "adamw", "adamw_clipped"])
def test_bf16_moments_match_jax_scale_by_adam_lowp(optimizer, wd, clip):
    """Five updates of the bf16-moment Adam against the JAX package's
    ``scale_by_adam_lowp`` chain (then ``add_decayed_weights`` for adamw,
    then the learning rate): parameters within 1e-6 relative, and the
    stored bf16 moments within one bf16 ulp of the JAX ones after every
    update."""
    cfg = dict(optimizer=optimizer, weight_decay=wd, max_grad_norm=clip,
               optimizer_state_dtype="bfloat16")
    params, opt, steps = _run_item4(cfg, 1, seed=6)
    assert isinstance(opt, t_optim.AdamLowp)
    for n, (got, want, jstate) in enumerate(steps):
        for g, w, shape in zip(got, want, ITEM4_SHAPES):
            assert _rel_err(g, w) <= 1e-6, (n, shape, _rel_err(g, w))
    adam = _jax_adam_state(steps[-1][2])
    for p, mu, nu in zip(params, adam.mu, adam.nu):
        st = opt.state[p]
        for got, want in ((st["exp_avg"], mu), (st["exp_avg_sq"], nu)):
            assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
            g = got.float().numpy()
            w = np.asarray(want).astype(np.float32)
            assert (np.abs(g - w) <= _bf16_ulp(np.maximum(np.abs(g), np.abs(w)))).all(), \
                (p.shape, np.abs(g - w).max())
    assert opt.state[params[0]]["step"] == 5


@pytest.mark.parametrize("kind", ["lamb", "bf16_adamw"])
def test_item4_state_round_trips_through_a_checkpoint(kind, tmp_path):
    """``state_dict()`` holds the step count and the moments in their own
    dtype (bf16 for the low-precision Adam, fp32 for LAMB); saved with
    ``torch.save`` and loaded into a fresh optimizer (whose
    ``load_state_dict`` would otherwise cast them to the parameters' fp32)
    the dtypes stay, and the next step equals the uninterrupted one bit for
    bit."""
    cfg = (t_config.TrainConfig(optimizer="lamb", weight_decay=0.01) if kind == "lamb"
           else t_config.TrainConfig(optimizer="adamw", weight_decay=0.01,
                                     optimizer_state_dtype="bfloat16"))
    want_dtype = torch.float32 if kind == "lamb" else torch.bfloat16
    rng = np.random.RandomState(8)
    p0 = [rng.randn(*s).astype(np.float32) for s in ITEM4_SHAPES]

    def make():
        ps = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
        return ps, t_optim.build_optimizer(cfg, ps)[0]

    a, opt_a = make()
    for _ in range(3):
        for p in a:
            p.grad = torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
        opt_a.step()
    torch.save(opt_a.state_dict(), tmp_path / "opt.pt")
    b, opt_b = make()
    with torch.no_grad():
        for pa, pb in zip(a, b):
            pb.copy_(pa)
    opt_b.load_state_dict(torch.load(tmp_path / "opt.pt"))
    for sd in (opt_a.state_dict(), opt_b.state_dict()):
        for st in sd["state"].values():
            assert set(st) == {"step", "exp_avg", "exp_avg_sq"} and st["step"] == 3
            assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == want_dtype
    g = [torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in ITEM4_SHAPES]
    for ps, opt in ((a, opt_a), (b, opt_b)):
        for p, gi in zip(ps, g):
            p.grad = gi.clone()
        opt.step()
    for pa, pb in zip(a, b):
        assert torch.equal(pa, pb)
    for pa, pb in zip(a, b):
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt_a.state[pa][k], opt_b.state[pb][k])


def test_foreach_buckets_cut_the_parameter_list_in_order(monkeypatch):
    """The foreach runs cover every parameter once, in order, each run at
    most ``FOREACH_BUCKET`` elements unless one tensor is larger; a bucket
    size that cuts the list into many runs gives the same LAMB and bf16
    steps bit for bit."""
    sizes = [5, 3, 9, 2, 2, 7]
    ts = [torch.zeros(n) for n in sizes]
    runs = list(t_optim._buckets(ts, limit=8))
    assert [[t.numel() for t in r] for r in runs] == [[5, 3], [9], [2, 2], [7]]
    rng = np.random.RandomState(9)
    p0 = [rng.randn(*s).astype(np.float32) for s in ITEM4_SHAPES]
    grads = [[rng.randn(*s).astype(np.float32) for s in ITEM4_SHAPES] for _ in range(3)]
    for cfg in (t_config.TrainConfig(optimizer="lamb", weight_decay=0.01),
                t_config.TrainConfig(optimizer_state_dtype="bfloat16")):
        out = []
        for limit in (t_optim.FOREACH_BUCKET, 40):
            monkeypatch.setattr(t_optim, "FOREACH_BUCKET", limit)
            ps = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
            opt = t_optim.build_optimizer(cfg, ps)[0]
            for g in grads:
                for p, gi in zip(ps, g):
                    p.grad = torch.from_numpy(gi.copy())
                opt.step()
            out.append(ps)
        for pa, pb in zip(*out):
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
