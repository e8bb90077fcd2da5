"""The port's block-sparse attention against the JAX package, on the CPU.

The same numpy-seeded inputs go through the JAX package (its Pallas
kernels in interpret mode, as tests/unit/test_flash_sparse.py runs them)
and through the port, whose wrappers run their plain PyTorch versions on
CPU tensors (the CUDA kernels are held against those plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py).

* layouts: every mode's ``make_layout`` equals the JAX copy's, including
  the per-head ``fixed`` patterns and the seeded random blocks of variable
  and bigbird; the three index builders are equal;
* attention: fp32 out within 2e-5 and the q/k/v gradients within 1e-4
  (tests/unit/test_flash_sparse.py's bounds), on the JAX package's
  packed-heads path (a shared layout with h * d % 128 == 0) and its
  per-head path (a per-head layout, or h * d % 128 != 0), causal and not,
  with a key-padding bias, a score bias, and a fully masked row; lse
  against a masked dense log-sum-exp in numpy (2e-5);
* the port's own walk tables: every active pair walked once, tiles in
  launch order; units of like walks packed into a tile (the transposed
  walk of ``fixed`` groups its global columns), never more steps than
  sequence order;
* ``SparseSelfAttention`` with 'add' / 'mul' masks and ``rpe`` against the
  JAX module; ``SparseAttentionUtils`` against the JAX helpers.

Each JAX result is computed once (module-scoped cache); shapes stay tiny
because the Pallas interpreter is slow.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops.sparse_attention import block_sparse_attention as jbsa
from deepspeed_tpu.ops.sparse_attention import sparsity_config as jsc
from deepspeed_tpu.ops.sparse_attention import (
    SparseSelfAttention as JSparseSelfAttention,
    SparseAttentionUtils as JUtils)
from deepspeed_tpu_torch.ops.sparse_attention import \
    block_sparse_attention as tbsa
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as tsc
from deepspeed_tpu_torch.ops.sparse_attention import (
    SparseSelfAttention, SparseAttentionUtils)

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

OUT_TOL, GRAD_TOL = 2e-5, 1e-4

MODES = {
    "dense": {"mode": "dense", "block": 16},
    "fixed_uni": {"mode": "fixed", "block": 16, "num_local_blocks": 4,
                  "attention": "unidirectional"},
    "fixed_bi_horizontal": {"mode": "fixed", "block": 16,
                            "num_local_blocks": 4, "num_global_blocks": 2,
                            "horizontal_global_attention": True},
    "fixed_per_head": {"mode": "fixed", "block": 16,
                       "different_layout_per_head": True,
                       "num_local_blocks": 4,
                       "attention": "unidirectional",
                       "num_different_global_patterns": 4},
    "variable_random": {"mode": "variable", "block": 16,
                        "different_layout_per_head": True,
                        "num_random_blocks": 2,
                        "local_window_blocks": [2, 3],
                        "global_block_indices": [0, 5],
                        "global_block_end_indices": [2, 6], "seed": 7},
    "bigbird_random": {"mode": "bigbird", "block": 16,
                       "different_layout_per_head": True,
                       "num_random_blocks": 2, "seed": 3},
    "bslongformer": {"mode": "bslongformer", "block": 32,
                     "global_block_indices": [1]},
    "sliding_window": {"mode": "sliding_window", "block": 16,
                       "num_sliding_window_blocks": 3},
}


@pytest.mark.parametrize("name", sorted(MODES))
@pytest.mark.parametrize("seq,heads", [(256, 4), (512, 3)])
def test_layouts_match_jax(name, seq, heads):
    j = jsc.sparsity_config_from_dict(dict(MODES[name]), heads)
    t = tsc.sparsity_config_from_dict(dict(MODES[name]), heads)
    assert type(t).__name__ == type(j).__name__
    for _ in range(2):          # the random streams advance alike
        lay = t.make_layout(seq)
        assert np.array_equal(lay, j.make_layout(seq))
        assert lay.dtype == np.int64
    assert getattr(t, "requires_causal", False) == \
        getattr(j, "requires_causal", False)
    assert np.array_equal(tsc.causal_sliding_window_layout(heads, 9, 3),
                          jsc.causal_sliding_window_layout(heads, 9, 3))


def test_index_builders_match_jax():
    lay = jsc.sparsity_config_from_dict(dict(MODES["bigbird_random"]),
                                        3).make_layout(256)
    lay[:, 2] = 0                                       # an empty row
    for fn, args in ((tbsa.build_block_index, ()),
                     (tbsa.build_pair_index, ()),
                     (tbsa.build_group_index, (3,))):
        got = fn(lay, *args)
        want = getattr(jbsa, fn.__name__)(lay, *args)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert np.array_equal(a, b), fn.__name__


def _layout(case):
    name, heads, seq = case["layout"], case["h"], case["s"]
    if name == "masked_row":
        # query block 0 sees only key block 1 (above the causal diagonal)
        # and query block 2 sees nothing
        lay = np.ones((heads, seq // 16, seq // 16), np.int64)
        lay[:, 0] = 0
        lay[:, 0, 1] = 1
        lay[:, 2] = 0
        return lay, 16
    cfg = jsc.sparsity_config_from_dict(dict(MODES[name]), heads)
    return cfg.make_layout(seq), cfg.block


# name -> layout, heads, d_head, seq, causal, kpm, bias
CASES = {
    "packed_causal": dict(layout="fixed_uni", h=4, d=32, s=128, causal=True,
                          kpm=False, bias=False),
    "packed_kpm": dict(layout="fixed_bi_horizontal", h=4, d=32, s=128,
                       causal=False, kpm=True, bias=False),
    "packed_causal_bias": dict(layout="bslongformer", h=2, d=64, s=128,
                               causal=True, kpm=False, bias=True),
    "per_head_layout": dict(layout="fixed_per_head", h=4, d=32, s=128,
                            causal=True, kpm=True, bias=True),
    "per_head_random": dict(layout="bigbird_random", h=2, d=32, s=128,
                            causal=False, kpm=False, bias=True),
    "per_head_width": dict(layout="fixed_uni", h=3, d=32, s=128,
                           causal=False, kpm=True, bias=False),
    "masked_row": dict(layout="masked_row", h=3, d=32, s=64, causal=True,
                       kpm=False, bias=False),
}


def _inputs(case, seed=0):
    rng = np.random.RandomState(seed)
    shape = (2, case["h"], case["s"], case["d"])
    q, k, v, do = (rng.randn(*shape).astype(np.float32) for _ in range(4))
    kpm = bias = None
    if case["kpm"]:
        kpm = rng.randn(2, case["s"]).astype(np.float32)
        kpm[rng.rand(2, case["s"]) < 0.2] = -1e4
    if case["bias"]:
        bias = rng.randn(case["s"], case["s"]).astype(np.float32)
    return q, k, v, do, kpm, bias


_JAX = {}


def _jax_result(name):
    """(out, dq, dk, dv) of the JAX kernels for CASES[name], computed once
    per module."""
    if name not in _JAX:
        case = CASES[name]
        lay, block = _layout(case)
        q, k, v, do, kpm, bias = _inputs(case)
        attn = jbsa.make_block_sparse_attention(
            lay, block, causal=case["causal"], has_kpm=kpm is not None,
            has_bias=bias is not None, interpret=True)
        extra = (None if kpm is None else jnp.asarray(kpm),
                 None if bias is None else jnp.asarray(bias))
        out, vjp = jax.vjp(lambda q, k, v: attn(q, k, v, *extra),
                           jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        _JAX[name] = tuple(np.asarray(t) for t in (out, *vjp(
            jnp.asarray(do))))
    return _JAX[name]


def _dense_lse(q, k, lay, block, causal, kpm, bias):
    """Masked dense log-sum-exp in float64 numpy; NEG_INF for empty rows."""
    s, d = q.shape[2], q.shape[3]
    keep = np.kron(lay, np.ones((block, block))).astype(bool)[None]
    if causal:
        keep = keep & np.tril(np.ones((s, s), bool))[None, None]
    sc = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                   k.astype(np.float64)) / np.sqrt(d)
    if kpm is not None:
        sc = sc + kpm[:, None, None, :]
    if bias is not None:
        sc = sc + bias
    sc = np.where(keep, sc, -np.inf)
    m = sc.max(-1)
    live = np.isfinite(m)
    safe = np.where(live, m, 0.0)
    total = np.where(keep, np.exp(sc - safe[..., None]), 0.0).sum(-1)
    lse = safe + np.log(np.where(live, total, 1.0))
    return np.where(live, lse, tbsa.NEG_INF).astype(np.float32)


@pytest.mark.parametrize("name", sorted(CASES))
def test_attention_and_grads_match_jax(name):
    case = CASES[name]
    lay, block = _layout(case)
    q, k, v, do, kpm, bias = _inputs(case)
    j_out, j_dq, j_dk, j_dv = _jax_result(name)
    shared = bool((lay == lay[:1]).all())
    packed = shared and case["h"] * case["d"] % 128 == 0
    assert packed == name.startswith("packed")
    attn = tbsa.make_block_sparse_attention(
        lay, block, causal=case["causal"], has_kpm=kpm is not None,
        has_bias=bias is not None, pack=4)
    assert attn.tables.shared == shared
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    extra = [None if a is None else torch.from_numpy(a) for a in (kpm, bias)]
    out = attn(qt, kt, vt, *extra)
    out.backward(torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), j_out, rtol=0,
                               atol=OUT_TOL)
    for got, want in ((qt.grad, j_dq), (kt.grad, j_dk), (vt.grad, j_dv)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=GRAD_TOL)
    _, lse = tbsa.block_sparse_fwd(qt.detach(), kt.detach(), vt.detach(),
                                   *extra, tables=attn.tables,
                                   causal=case["causal"])
    want_lse = _dense_lse(q, k, lay, block, case["causal"], kpm, bias)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=0, atol=2e-5)
    if name == "masked_row":
        assert np.abs(out.detach().numpy()[:, :, :16]).max() == 0.0
        assert np.abs(qt.grad.numpy()[:, :, 32:48]).max() == 0.0
        assert (lse.numpy()[:, :, 32:48] == tbsa.NEG_INF).all()


@pytest.mark.parametrize("name", ["fixed_uni", "fixed_per_head",
                                  "bigbird_random", "bslongformer"])
@pytest.mark.parametrize("block", [16, 128])
def test_walks_cover_every_active_pair_once(name, block):
    cfg = dict(MODES[name], block=block)
    lay = tsc.sparsity_config_from_dict(cfg, 3).make_layout(1024)
    tables = tbsa.LayoutTables(lay, block)
    for walk, side in ((tables.fwd, tables.layout),
                       (tables.bwd, tables.layout.transpose(0, 2, 1))):
        for h in range(tables.layout_heads):
            pos = walk.anchor_positions(h)
            anchors = pos[pos >= 0]
            assert np.array_equal(np.sort(anchors), np.arange(1024))
            covered = np.zeros_like(side[h])
            for t in range(walk.n_tiles):
                rows = np.unique(pos[t][pos[t] >= 0] // block)
                blocks = walk.walk(h, t)
                assert np.all(np.diff(blocks) > 0)
                for r in rows:
                    assert side[h][r][blocks].sum() == side[h][r].sum()
                    covered[r, blocks] |= side[h][r, blocks]
            assert np.array_equal(covered, side[h])
            steps = walk.lengths[h][walk.order[h]]
            assert np.all(np.diff(steps) <= 0)          # longest first
    assert tables.n_active == int(np.asarray(lay).sum())


def _grid_walks(rows, grid, block, unit):
    """(steps, idle warp-steps) of the tiles of ``grid`` (n_tiles,
    TILE // unit; -1 = none) walking ``rows`` ([own block][other block]):
    steps of TILE tokens (one block where blocks are larger), and the
    (unit slot, step) pairs in which the slot holds no pair of the layout
    (a warp of the kernels owns a unit slot and idles there)."""
    steps = idle = 0
    per_step = max(1, tbsa.TILE // block)
    for g in grid:
        blocks = np.where(g >= 0, g * unit // block, -1)
        walk = np.nonzero(rows[blocks[blocks >= 0]].any(0))[0]
        for at in range(0, len(walk), per_step):
            cols = walk[at:at + per_step]
            idle += sum(b < 0 or not rows[b][cols].any() for b in blocks)
        steps += -(-len(walk) * block // tbsa.TILE)
    return steps, idle


@pytest.mark.parametrize("name", ["fixed_uni", "fixed_per_head",
                                  "bigbird_random", "bslongformer"])
@pytest.mark.parametrize("block", [16, 128])
@pytest.mark.parametrize("seq", [1024, 2048])
def test_walks_pack_units_of_like_walks(name, block, seq):
    """The host plan that packs units into tiles: each side's walks take
    the steps their tiles' units need, never more steps and never more idle
    warp-steps than tiles of units in sequence order; under ``fixed`` at
    block 16 the transposed walk packs the global columns (the keys every
    later query sees) together, so at most half the warp-steps idle that
    sequence order would idle."""
    cfg = dict(MODES[name], block=block)
    lay = tsc.sparsity_config_from_dict(cfg, 3).make_layout(seq)
    tables = tbsa.LayoutTables(lay, block)
    for walk, side in ((tables.fwd, tables.layout),
                       (tables.bwd, tables.layout.transpose(0, 2, 1))):
        per_tile = tbsa.TILE // walk.unit
        n_units = tables.nb * block // walk.unit
        in_order = np.full(walk.n_tiles * per_tile, -1)
        in_order[:n_units] = np.arange(n_units)
        in_order = in_order.reshape(walk.n_tiles, per_tile)
        for h in range(tables.layout_heads):
            steps, idle = _grid_walks(side[h], walk.units[h], block,
                                      walk.unit)
            want_steps, want_idle = _grid_walks(side[h], in_order, block,
                                                walk.unit)
            assert steps == int((-(-walk.lengths[h] * block //
                                   tbsa.TILE)).sum())
            assert steps <= want_steps and idle <= want_idle
            if walk is tables.bwd and name.startswith("fixed") and \
                    block == 16:
                assert steps < want_steps and 2 * idle <= want_idle


def _module_inputs(seed=3):
    rng = np.random.RandomState(seed)
    b, h, s, d = 2, 4, 64, 16
    q, k, v = (rng.randn(b, h, s, d).astype(np.float32) for _ in range(3))
    kpm_mul = (rng.rand(b, s) > 0.2).astype(np.float32)
    kpm_mul[:, 0] = 1.0
    kpm_add = np.where(kpm_mul > 0, 0.0, -1e4).astype(np.float32)
    am_mul = np.tril(np.ones((s, s), np.float32))
    am_add = rng.randn(s, s).astype(np.float32)
    rpe = rng.randn(s, s).astype(np.float32) * 0.1
    return q, k, v, kpm_mul, kpm_add, am_mul, am_add, rpe


@pytest.mark.parametrize("kpm_mode,am_mode,with_rpe", [
    ("add", "mul", False), ("mul", "add", True), ("mul", "mul", True)])
def test_sparse_self_attention_matches_jax(kpm_mode, am_mode, with_rpe):
    q, k, v, kpm_mul, kpm_add, am_mul, am_add, rpe = _module_inputs()
    kpm = kpm_mul if kpm_mode == "mul" else kpm_add
    am = am_mul if am_mode == "mul" else am_add
    cfg = dict(MODES["fixed_uni"])
    mods = []
    for sc_mod, cls in ((jsc, JSparseSelfAttention),
                        (tsc, SparseSelfAttention)):
        mods.append(cls(sc_mod.sparsity_config_from_dict(cfg, 4),
                        key_padding_mask_mode=kpm_mode,
                        attn_mask_mode=am_mode, max_seq_length=128))
    jmod, tmod = mods
    kw = dict(key_padding_mask=kpm, attn_mask=am,
              rpe=rpe if with_rpe else None)
    want = np.asarray(jmod(*(jnp.asarray(a) for a in (q, k, v)),
                           **{n: None if a is None else jnp.asarray(a)
                              for n, a in kw.items()}))
    got = tmod(*(torch.from_numpy(a) for a in (q, k, v)),
               **{n: None if a is None else torch.from_numpy(a)
                  for n, a in kw.items()})
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=OUT_TOL)
    # the master layout sliced for the shorter sequence, one kernel cached
    assert np.array_equal(tmod.get_layout(64), jmod.get_layout(64))
    assert list(tmod._kernels) == [(64, True, True)]
    with pytest.raises(ValueError, match="divisible"):
        tmod.get_layout(70)


def test_sparse_attention_utils_match_jax():
    rng = np.random.RandomState(4)
    w = rng.randn(10, 6).astype(np.float32)
    for reserved in (0, 2):
        got = SparseAttentionUtils.extend_position_embedding(
            torch.from_numpy(w), 23, reserved)
        want = JUtils.extend_position_embedding(jnp.asarray(w), 23, reserved)
        assert np.array_equal(got.numpy(), np.asarray(want))
    ids = rng.randint(0, 50, (2, 13))
    mask = np.ones((2, 13), np.int64)
    pos = np.tile(np.arange(13), (2, 1))
    emb = rng.randn(2, 13, 6).astype(np.float32)
    table = rng.randn(50, 6).astype(np.float32)
    got = SparseAttentionUtils.pad_to_block_size(
        16, torch.from_numpy(ids), torch.from_numpy(mask), None,
        torch.from_numpy(pos), torch.from_numpy(emb), pad_token_id=1,
        model_embeddings=torch.from_numpy(table))
    want = JUtils.pad_to_block_size(
        16, jnp.asarray(ids), jnp.asarray(mask), None, jnp.asarray(pos),
        jnp.asarray(emb), pad_token_id=1, model_embeddings=jnp.asarray(table))
    assert got[0] == want[0] == 3
    for a, b in zip(got[1:], want[1:]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b))
    out = SparseAttentionUtils.unpad_sequence_output(3, got[5])
    assert out.shape == (2, 13, 6)
