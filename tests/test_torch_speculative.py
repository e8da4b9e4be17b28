"""PyTorch port: speculative decoding (``models/generate.py``:
``generate_speculative``, ``self_draft``, ``generate_speculative_seq2seq``)
held to the JAX package's contract and against its acceptance functions.

The contract is the target's own output: at temperature 0 the tokens
equal ``generate_causal``'s (``generate``'s for T5) greedy tokens for any
draft and any ``speculate_k``, and equal the JAX package's greedy tokens
on the same weights; above it each emitted token follows the target's
warped distribution (the Leviathan acceptance's marginal, within the JAX
test's total-variation bounds over 200k draws of the port's own
streams). ``speculative_accept_greedy`` and ``_speculative_accept`` equal
the JAX functions exactly on shared inputs and draws. The JAX tests'
Llama cases run on GPT-2 here (the port has no Llama yet)."""

import numpy as np
import pytest
import torch

from huggingface_sagemaker_tensorflow_distributed_tpu_torch.models import generate as t_gen
from torch_decode_pairs import (  # noqa: F401  (autouse fixtures)
    detached_compile_trackers,
    gpt2_pair,
    one_torch_thread,
    seq2seq_pair,
)


def _gpt2(num_layers, seed):
    return gpt2_pair(num_layers=num_layers, seed=seed)[2]


@pytest.mark.parametrize("k", [1, 3, 5])
def test_speculative_matches_greedy(k):
    """Against the port's and the JAX package's greedy tokens."""
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.models.generate import (
        generate_causal,
    )

    jmodel, params, target = gpt2_pair(3, seed=0)
    draft = _gpt2(1, seed=1)
    ids = np.random.RandomState(0).randint(3, 128, (1, 7))
    want = t_gen.generate_causal(target, ids, max_new_tokens=16)
    got = t_gen.generate_speculative(target, draft, ids, max_new_tokens=16, speculate_k=k)
    assert torch.equal(got, want)
    jax_want = generate_causal(jmodel, params, jnp.asarray(ids), max_new_tokens=16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_want))


def test_speculative_perfect_draft_full_acceptance():
    target = _gpt2(2, seed=0)
    ids = np.random.RandomState(1).randint(3, 128, (1, 5))
    want = t_gen.generate_causal(target, ids, max_new_tokens=12)
    assert torch.equal(t_gen.generate_speculative(target, target, ids, max_new_tokens=12,
                                                  speculate_k=4), want)


def test_speculative_eos_mid_window_pads_after():
    """A greedy continuation that hits EOS: the speculative output pads
    after it as ``generate_causal`` does (EOS inside a verify window)."""
    import dataclasses

    target, draft = _gpt2(2, seed=3), _gpt2(1, seed=4)
    ids = np.random.RandomState(6).randint(3, 128, (1, 6))
    free = t_gen.generate_causal(target, ids, max_new_tokens=12)
    eos = int(free[0, 5])
    target.config = dataclasses.replace(target.config, eos_token_id=eos)
    want = t_gen.generate_causal(target, ids, max_new_tokens=12)
    assert (want == eos).any() and (want[0, -1] == target.config.pad_token_id)
    got = t_gen.generate_speculative(target, draft, ids, max_new_tokens=12, speculate_k=3)
    assert torch.equal(got, want)


def test_speculative_batched_rows_advance_independently():
    target, draft = _gpt2(3, seed=0), _gpt2(1, seed=1)
    ids = np.random.RandomState(11).randint(3, 128, (4, 7))
    want = t_gen.generate_causal(target, ids, max_new_tokens=14)
    got = t_gen.generate_speculative(target, draft, ids, max_new_tokens=14, speculate_k=3)
    assert torch.equal(got, want)
    mask = np.ones((4, 7), np.int64)
    mask[0, 5:] = 0
    mask[2, 3:] = 0
    ids = ids * mask
    want = t_gen.generate_causal(target, ids, mask, max_new_tokens=14)
    got = t_gen.generate_speculative(target, draft, ids, mask, max_new_tokens=14,
                                     speculate_k=3)
    assert torch.equal(got, want)


def test_speculative_rejects_bad_inputs():
    target, draft = _gpt2(2, seed=0), _gpt2(1, seed=1)
    with pytest.raises(ValueError, match="speculate_k"):
        t_gen.generate_speculative(target, draft, np.ones((1, 4), np.int64), speculate_k=0)
    other = gpt2_pair(1, seed=2, vocab=64)[2]
    with pytest.raises(ValueError, match="vocabulary"):
        t_gen.generate_speculative(target, other, np.ones((1, 4), np.int64))


def test_speculative_right_padded_prompt_matches_unpadded():
    target, draft = _gpt2(3, seed=0), _gpt2(1, seed=1)
    ids = np.random.RandomState(5).randint(3, 128, (1, 7))
    want = t_gen.generate_speculative(target, draft, ids, max_new_tokens=12, speculate_k=3)
    padded = np.zeros((1, 16), np.int64)
    padded[:, :7] = ids
    mask = np.zeros((1, 16), np.int64)
    mask[:, :7] = 1
    got = t_gen.generate_speculative(target, draft, padded, mask, max_new_tokens=12,
                                     speculate_k=3)
    assert torch.equal(got, want)
    assert torch.equal(got, t_gen.generate_causal(target, padded, mask, max_new_tokens=12))


def test_speculative_left_padded_rejected():
    target, draft = _gpt2(2, seed=0), _gpt2(1, seed=1)
    ids = np.ones((1, 8), np.int64) * 5
    mask = np.concatenate([np.zeros((1, 3), np.int64), np.ones((1, 5), np.int64)], axis=1)
    with pytest.raises(ValueError, match="RIGHT-padded"):
        t_gen.generate_speculative(target, draft, ids, mask)


def test_self_draft_matches_greedy_and_shares_the_targets_tensors():
    target = _gpt2(3, seed=0)
    draft = t_gen.self_draft(target, 1)
    assert draft.config.num_layers == 1 and len(draft.backbone.h) == 1
    own = {p.data_ptr() for p in target.parameters()}
    assert all(p.data_ptr() in own for p in draft.parameters())    # nothing copied
    assert draft.backbone.h[0] is target.backbone.h[0]
    ids = np.random.RandomState(7).randint(3, 128, (1, 6))
    want = t_gen.generate_causal(target, ids, max_new_tokens=10)
    assert torch.equal(t_gen.generate_speculative(target, draft, ids, max_new_tokens=10,
                                                  speculate_k=3), want)


def test_self_draft_rejects_bad_layer_counts():
    """The JAX ``ValueError`` word for word."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.generate import self_draft

    jmodel, params, target = gpt2_pair(3, seed=0)
    for n in (0, 3):
        with pytest.raises(ValueError) as want:
            self_draft(jmodel, params, n)
        with pytest.raises(ValueError, match="num_layers") as got:
            t_gen.self_draft(target, n)
        assert str(got.value) == str(want.value)


def test_speculative_stats_reporting():
    target = _gpt2(2, seed=0)
    ids = np.random.RandomState(3).randint(3, 128, (1, 5))
    tokens, stats = t_gen.generate_speculative(target, target, ids, max_new_tokens=12,
                                               speculate_k=3, return_stats=True)
    want = t_gen.generate_causal(target, ids, max_new_tokens=12)
    assert torch.equal(tokens, want)
    assert stats["window_ceiling"] == 4
    assert 1.0 <= stats["accepted_per_window"] <= 4.0
    if not (want == target.config.eos_token_id).any():
        assert stats["iterations"] == 3          # ceil((12 - 1) / 4)
        assert stats["accepted_per_window"] == 4.0
        assert stats["tokens_generated"] == [12]


def _trials(p, q, n, gen):
    """``n`` first-position draws of the acceptance on the port's streams:
    the draft token from ``q``, then ``_speculative_accept``."""
    V = p.shape[-1]
    d = t_gen._categorical(torch.log(q[0]).expand(n, V), t_gen._gumbel((n, V), gen, "cpu"))
    n_acc, nxt = t_gen._speculative_accept(
        p.expand(n, -1, -1), q.expand(n, -1, -1), d[:, None],
        torch.rand(n, 1, generator=gen), t_gen._gumbel((n, V), gen, "cpu"),
        t_gen._gumbel((n, V), gen, "cpu"))
    return d, n_acc, nxt


def test_rejection_acceptance_marginal_is_target_distribution():
    """The Leviathan theorem on the port's acceptance: the emitted first
    token's marginal is p[0] within total variation 0.012 over 200k
    draws, and the bonus after an acceptance follows p[1] within 0.015."""
    rng = np.random.RandomState(0)
    p = torch.from_numpy(rng.dirichlet(np.ones(8), size=2).astype(np.float32))
    q = torch.from_numpy(rng.dirichlet(np.ones(8), size=1).astype(np.float32))
    gen = torch.Generator().manual_seed(42)
    d, n_acc, nxt = _trials(p, q, 200_000, gen)
    emitted = torch.where(n_acc > 0, d, nxt.long())
    counts = np.bincount(emitted.numpy(), minlength=8) / len(emitted)
    tv = 0.5 * np.abs(counts - p[0].numpy()).sum()
    assert tv < 0.012, f"total variation {tv:.4f} vs target"
    bonus = nxt[n_acc == 1].long()
    counts2 = np.bincount(bonus.numpy(), minlength=8) / len(bonus)
    tv2 = 0.5 * np.abs(counts2 - p[1].numpy()).sum()
    assert tv2 < 0.015, f"bonus total variation {tv2:.4f}"


def test_acceptance_equals_jax_on_shared_draws():
    """``speculative_accept_greedy`` and ``_speculative_accept`` against the
    JAX functions, the latter fed the draws JAX's key makes."""
    import jax
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.models import generate as j_gen

    rng = np.random.RandomState(3)
    B, k, V = 16, 3, 12
    t_pred = rng.randint(0, 4, (B, k + 1)).astype(np.int32)
    drafts = rng.randint(0, 4, (B, k)).astype(np.int32)
    n_acc, bonus = t_gen.speculative_accept_greedy(torch.from_numpy(t_pred),
                                                   torch.from_numpy(drafts))
    jn, jb = j_gen.speculative_accept_greedy(jnp.asarray(t_pred), jnp.asarray(drafts))
    np.testing.assert_array_equal(n_acc.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(bonus.numpy(), np.asarray(jb))

    p = rng.dirichlet(np.ones(V) * 0.5, size=(B, k + 1)).astype(np.float32)
    q = rng.dirichlet(np.ones(V) * 0.5, size=(B, k)).astype(np.float32)
    drafts = np.stack([[rng.choice(V, p=q[b, i]) for i in range(k)]
                       for b in range(B)]).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    want_n, want_t = jax.vmap(j_gen._speculative_accept)(jnp.asarray(p), jnp.asarray(q),
                                                         jnp.asarray(drafts), keys)
    u, g_res, g_bonus = [], [], []
    for key in keys:
        key_u, key_res, key_bonus = jax.random.split(key, 3)
        u.append(np.asarray(jax.random.uniform(key_u, (k,))))
        g_res.append(np.asarray(jax.random.gumbel(key_res, (V,))))
        g_bonus.append(np.asarray(jax.random.gumbel(key_bonus, (V,))))
    got_n, got_t = t_gen._speculative_accept(
        torch.from_numpy(p), torch.from_numpy(q), torch.from_numpy(drafts),
        torch.from_numpy(np.stack(u)), torch.from_numpy(np.stack(g_res)),
        torch.from_numpy(np.stack(g_bonus)))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    assert 0 < int((got_n < k).sum()) < B          # both branches taken


def test_sampled_speculative_end_to_end():
    """temperature > 0: seeded, the seed matters, in-vocab tokens, pads
    after EOS."""
    target, draft = _gpt2(3, seed=0), _gpt2(1, seed=1)
    ids = np.random.RandomState(0).randint(3, 128, (2, 6))
    kw = dict(max_new_tokens=12, speculate_k=3, temperature=0.8)
    a = t_gen.generate_speculative(target, draft, ids, seed=7, **kw)
    assert torch.equal(a, t_gen.generate_speculative(target, draft, ids, seed=7, **kw))
    assert not torch.equal(a, t_gen.generate_speculative(target, draft, ids, seed=8, **kw))
    assert bool(((a >= 0) & (a < 128)).all())
    eos = target.config.eos_token_id
    for row in a.tolist():
        if eos in row:
            assert all(t == target.config.pad_token_id for t in row[row.index(eos) + 1:])


def test_sampled_speculative_with_warpers():
    """top-k/top-p warp both p and q; top-k at the vocabulary is no filter
    and draws the same stream as plain temperature sampling."""
    target, draft = _gpt2(2, seed=0), _gpt2(1, seed=1)
    ids = np.random.RandomState(1).randint(3, 128, (1, 6))
    kw = dict(max_new_tokens=10, speculate_k=3, temperature=0.7, seed=3)
    a = t_gen.generate_speculative(target, draft, ids, top_k=5, **kw)
    assert torch.equal(a, t_gen.generate_speculative(target, draft, ids, top_k=5, **kw))
    assert bool(((a >= 0) & (a < 128)).all())
    assert torch.equal(t_gen.generate_speculative(target, draft, ids, top_k=128, **kw),
                       t_gen.generate_speculative(target, draft, ids, **kw))
    with pytest.raises(ValueError, match="temperature"):
        t_gen.generate_speculative(target, draft, ids, top_k=5)


# -- seq2seq ----------------------------------------------------------------------

def _t5(num_layers, seed):
    return seq2seq_pair("t5", num_layers=num_layers, seed=seed)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_t5_speculative_matches_greedy(k):
    import jax.numpy as jnp

    from huggingface_sagemaker_tensorflow_distributed_tpu.models.generate import generate

    jmodel, params, target = _t5(2, seed=0)
    draft = _t5(1, seed=1)[2]
    src = np.random.RandomState(0).randint(3, 96, (2, 8))
    mask = np.ones((2, 8), np.int64)
    mask[1, 6:] = 0
    want = t_gen.generate(target, src, mask, max_new_tokens=12)
    got = t_gen.generate_speculative_seq2seq(target, draft, src, mask, max_new_tokens=12,
                                             speculate_k=k)
    assert torch.equal(got, want)
    jax_want = generate(jmodel, params, jnp.asarray(src), jnp.asarray(mask), max_new_tokens=12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_want))


def test_t5_speculative_perfect_draft():
    target = _t5(2, seed=0)[2]
    src = np.random.RandomState(1).randint(3, 96, (2, 6))
    want = t_gen.generate(target, src, max_new_tokens=10)
    got, stats = t_gen.generate_speculative_seq2seq(target, target, src, max_new_tokens=10,
                                                    speculate_k=4, return_stats=True)
    assert torch.equal(got, want)
    assert stats["window_ceiling"] == 5
    if not (want == target.config.eos_token_id).any():
        assert stats["accepted_per_window"] == 5.0


def test_t5_speculative_sampled_deterministic():
    target, draft = _t5(2, seed=0)[2], _t5(1, seed=1)[2]
    src = np.random.RandomState(2).randint(3, 96, (1, 6))
    kw = dict(max_new_tokens=10, speculate_k=3, temperature=0.8, seed=5)
    a = t_gen.generate_speculative_seq2seq(target, draft, src, **kw)
    assert torch.equal(a, t_gen.generate_speculative_seq2seq(target, draft, src, **kw))
    assert bool(((a >= 0) & (a < 96)).all())


def test_bart_rejected():
    """BART and mBART: the JAX ``ValueError`` word for word."""
    from huggingface_sagemaker_tensorflow_distributed_tpu.models.generate import (
        generate_speculative_seq2seq,
    )

    jbart, bparams, bart = seq2seq_pair("bart", num_layers=1, seed=0, vocab=64)
    jt5, tparams, t5 = _t5(1, seed=0)
    with pytest.raises(ValueError) as want:
        generate_speculative_seq2seq(jbart, bparams, jt5, tparams, np.ones((1, 4), np.int64))
    with pytest.raises(ValueError, match="T5 family") as got:
        t_gen.generate_speculative_seq2seq(bart, t5, np.ones((1, 4), np.int64))
    assert str(got.value) == str(want.value)
