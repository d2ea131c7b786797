"""Port parity of K14, the multi-device paths: ring attention, the
sequence-parallel transformer backbone and forecast seed, the
tensor-parallel ViT and GPipe, run by the port on gloo ranks of CPU
processes (``parallel.dist.run_ranks``) against the JAX package on the
conftest's 8 virtual devices, from the same numpy inputs and param trees.

Each case of ``tests/test_ring_attention.py`` has its counterpart here at
the reference's own tolerances: the ring 2e-5, the backbone, the forecast
seed, the tensor-parallel ViT and GPipe 3e-5. One spawn per world size (1,
2, 4, 8 ranks, started together in one process) runs every check of that
world; the JAX side runs in this
process, each function under ``jax.jit`` (eager ``shard_map`` takes
minutes). Besides: the plain block attention against ``_block_attn`` on
masked blocks, the combine's no-op on a fully masked block after step 0
(what lets the card's kernel skip such blocks), and two faults shown
failing: a -inf mask sentinel and a row-parallel bias on every rank.
"""

import functools
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from sitewhere_tpu.models import common as jcommon
from sitewhere_tpu.models import transformer as jtf
from sitewhere_tpu.models import vit as jvit
from sitewhere_tpu.ops import ring_attention as jra
from sitewhere_tpu.ops.pipeline_parallel import pipeline_apply as j_pipeline_apply
from sitewhere_tpu_torch.models import common as tc
from sitewhere_tpu_torch.models import transformer as ttf
from sitewhere_tpu_torch.models import vit as tvit
from sitewhere_tpu_torch.ops import pipeline_parallel as tpp
from sitewhere_tpu_torch.ops import ring_attention as tra
from sitewhere_tpu_torch.parallel import dist as tdist

RING_TOL = 2e-5  # tests/test_ring_attention.py:40
MODEL_TOL = 3e-5  # :108, :151, :192
RING_CASES = [(2, True), (4, False), (8, True), (8, False)]  # :29-31
WORLDS = (1, 2, 4, 8)

torch.set_num_threads(1)


def _mesh(n, name):
    return Mesh(np.asarray(jax.devices()[:n]).reshape(n), (name,))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jit(fn, *args, **kw):
    """``fn(*args, **kw)`` of the JAX package under ``jax.jit`` (the
    arrays traced, the rest static)."""
    arrays = [i for i, a in enumerate(args) if isinstance(a, (np.ndarray, jax.Array, dict, list))]

    def run(*xs):
        full = list(args)
        for i, x in zip(arrays, xs):
            full[i] = x
        return fn(*full, **kw)

    return jax.jit(run)(*(args[i] for i in arrays))


def _port(tree):
    return tc.params_from_numpy(_np_tree(tree), "cpu")


@functools.lru_cache(maxsize=None)
def _qkv(b=2, t=64, h=4, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3))


@functools.lru_cache(maxsize=None)
def _tf_case(context: int):
    """The reference's backbone test config (context 64) or its forecast
    test's (context 512): params, and normed inputs or raw windows."""
    cfg = jtf.TransformerForecasterConfig(context=context, dim=32, depth=2, heads=4,
                                          dtype="float32")
    params = jtf.init(jax.random.PRNGKey(0), cfg)
    if context == 64:
        data = np.random.default_rng(1).standard_normal((2, 64)).astype(np.float32)
    else:
        t = np.linspace(0, 20, 512, dtype=np.float32)
        data = (21.0 + 4.0 * np.sin(t)[None] + np.zeros((2, 1), np.float32)).astype(np.float32)
    return cfg, params, data


def _port_tf_cfg(cfg):
    return ttf.TransformerForecasterConfig(context=cfg.context, dim=cfg.dim, depth=cfg.depth,
                                           heads=cfg.heads, dtype=cfg.dtype)


@functools.lru_cache(maxsize=None)
def _vit_case():
    cfg = jvit.ViTConfig(image_size=16, patch_size=8, dim=32, depth=2, heads=4, num_classes=7,
                         dtype="float32")
    rng = np.random.default_rng(1)
    imgs = rng.standard_normal((3, 16, 16, 3)).astype(np.float32)
    # every bias and LayerNorm affine off its init value, so a bias added
    # on every rank shows
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a + 0.05 * rng.standard_normal(a.shape).astype(np.float32))
        if a.ndim == 1 else a, _np_tree(jvit.init(jax.random.PRNGKey(0), cfg)))
    return cfg, params, imgs


def _port_vit_cfg(cfg):
    return tvit.ViTConfig(image_size=cfg.image_size, patch_size=cfg.patch_size, dim=cfg.dim,
                          depth=cfg.depth, heads=cfg.heads, num_classes=cfg.num_classes,
                          dtype=cfg.dtype)


def _bias_everywhere(blocks_stacked, full_blocks):
    """A fault: every rank's row-parallel layers (wo, fc2) carry the whole
    bias, so the psum adds it n times."""
    out = tc.tree_map(lambda a: a.clone(), blocks_stacked)
    for blk, full in zip(out, full_blocks):
        for node, src in ((blk["attn"]["wo"], full["attn"]["wo"]), (blk["mlp"]["fc2"],
                                                                   full["mlp"]["fc2"])):
            node["b"] = src["b"][None].expand_as(node["b"]).clone()
    return out


@functools.lru_cache(maxsize=None)
def _gpipe_case(depth=4, dim=32, heads=4, b=8, t=10, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), depth)
    blocks = [jcommon.transformer_block_init(k, dim, heads) for k in keys]
    x = np.random.default_rng(seed + 1).standard_normal((b, t, dim)).astype(np.float32)
    return blocks, x


def _stage(heads):
    return functools.partial(tc.block_stage, heads=heads, causal=False, dtype=torch.float32,
                             ops=tvit.KERNEL_OPS)


def _jobs(n: int):
    """Every port computation of the world of ``n`` ranks."""
    J = tdist.Job
    jobs = []
    for n_, causal in RING_CASES:
        if n_ == n:
            q, k, v = _qkv()
            jobs.append(J(f"ring_{causal}", tra.ring_attention,
                          dict(q=q, k=k, v=v, causal=causal)))
    if n == 1:
        q, k, v = _qkv(t=32)
        jobs.append(J("ring_True", tra.ring_attention, dict(q=q, k=k, v=v)))
        blk = jcommon.transformer_block_init(jax.random.PRNGKey(0), 16, 2)
        x = np.random.default_rng(2).standard_normal((4, 6, 16)).astype(np.float32)
        stacked = tc.tree_map(lambda a: a[None], _port(blk))
        jobs.append(J("gpipe_single", tpp.pipeline_apply,
                      dict(stage_params_stacked=stacked, x=x, stage_fn=_stage(2),
                           microbatches=2)))
    if n in (2, 4):
        cfg, params, imgs = _vit_case()
        blocks, rest = tvit.shard_params_tp(_port(params), n)
        jobs.append(J("vit_tp", tvit.apply_tp, dict(blocks_stacked=blocks, rest=rest,
                                                    cfg=_port_vit_cfg(cfg), images=imgs)))
    if n == 4:
        cfg, params, imgs = _vit_case()
        tp = _port(params)
        blocks, rest = tvit.shard_params_tp(tp, 4)
        jobs.append(J("vit_tp_bias_fault", tvit.apply_tp, dict(
            blocks_stacked=_bias_everywhere(blocks, tp["blocks"]), rest=rest,
            cfg=_port_vit_cfg(cfg), images=imgs)))
        blocks_j, x = _gpipe_case()
        stacked = tc.tree_map(lambda *xs: torch.stack(xs), *[_port(b) for b in blocks_j])
        for m in (2, 8):
            jobs.append(J(f"gpipe_{m}", tpp.pipeline_apply, dict(
                stage_params_stacked=stacked, x=x, stage_fn=_stage(4), microbatches=m)))
    if n == 8:
        q, k, v = _qkv(t=64)
        jobs.append(J("local", tra.ring_attention_local, dict(
            q=tdist.Shard(q, 1), k=tdist.Shard(k, 1), v=tdist.Shard(v, 1), causal=True)))
        q, k, v = _qkv(b=1, t=256, h=2, d=8, seed=3)
        jobs.append(J("long", tra.ring_attention, dict(q=q, k=k, v=v, causal=True)))
        cfg, params, normed = _tf_case(64)
        jobs.append(J("backbone", ttf.backbone_sharded, dict(
            params=_port(params), cfg=_port_tf_cfg(cfg), normed=normed)))
        cfg, params, windows = _tf_case(512)
        jobs.append(J("forecast_seed", ttf.forecast_seed_sharded, dict(
            params=_port(params), cfg=_port_tf_cfg(cfg), windows=windows)))
    return jobs


def _run_world(n: int):
    ranks = tdist.run_ranks(tdist.run_jobs, n, "gloo", "cpu", _jobs(n))
    return [{name: r["out"] for name, r in rank["out"].items()} for rank in ranks]


@functools.lru_cache(maxsize=None)
def _runs() -> dict:
    return {}


def _world(n: int):
    """World ``n``'s results, rank by rank ({job name: output}). In one
    process the four worlds start together at the first need; under
    pytest-xdist, whose workers each take a share of the tests, each worker
    starts only the worlds its tests need."""
    runs = _runs()
    if n not in runs:
        wanted = (n,) if "PYTEST_XDIST_WORKER" in os.environ else WORLDS
        pool = ThreadPoolExecutor(len(wanted))
        for m in wanted:
            runs.setdefault(m, pool.submit(_run_world, m))
        pool.shutdown(wait=False)
    return runs[n].result()


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _every_rank(n, name, want, tol):
    outs = [r[name] for r in _world(n)]
    for out in outs:
        _close(out, want, tol)
    for out in outs[1:]:  # the global result alike on every rank
        assert torch.equal(out, outs[0])


# -- the reference's cases --------------------------------------------------------

@pytest.mark.parametrize("n_shards,causal", RING_CASES)
def test_ring_matches_jax_ring(n_shards, causal):
    q, k, v = _qkv()
    want = _jit(jra.ring_attention, q, k, v, _mesh(n_shards, "seq"), "seq", causal=causal)
    _every_rank(n_shards, f"ring_{causal}", want, RING_TOL)
    _close(want, jra.full_attention_reference(q, k, v, causal=causal), RING_TOL)


def test_ring_single_shard_degenerates_to_full():
    q, k, v = _qkv(t=32)
    want = _jit(jra.ring_attention, q, k, v, _mesh(1, "seq"), "seq")
    _every_rank(1, "ring_True", want, RING_TOL)
    _close(tra.full_attention_reference(*map(torch.from_numpy, (q, k, v))),
           jra.full_attention_reference(q, k, v), RING_TOL)


def test_local_memory_is_block_sized():
    """Each rank's body sees [B, T/n, H, D] blocks and returns its block
    of the exact attention over the full sequence."""
    q, k, v = _qkv(t=64)
    outs = [r["local"] for r in _world(8)]
    assert all(tuple(o.shape) == (2, 64 // 8, 4, 16) for o in outs)
    want = _jit(jra.ring_attention, q, k, v, _mesh(8, "seq"), "seq", causal=True)
    _close(torch.cat(outs, 1), want, RING_TOL)


def test_long_context_beyond_single_block():
    q, k, v = _qkv(b=1, t=256, h=2, d=8, seed=3)
    want = _jit(jra.ring_attention, q, k, v, _mesh(8, "seq"), "seq", causal=True)
    _every_rank(8, "long", want, RING_TOL)


def test_transformer_backbone_sharded_matches_jax():
    cfg, params, normed = _tf_case(64)
    want = _jit(jtf.backbone_sharded, params, cfg, normed, _mesh(8, "seq"), "seq")
    _every_rank(8, "backbone", want, MODEL_TOL)
    _close(want, jtf._backbone(params, jnp.asarray(normed), cfg), MODEL_TOL)


def test_forecast_seed_sharded_runs_long_context():
    cfg, params, windows = _tf_case(512)
    want = _jit(jtf.forecast_seed_sharded, params, cfg, windows, _mesh(8, "seq"), "seq")
    for rank in _world(8):
        mu, sigma = rank["forecast_seed"]
        assert mu.shape == (2,) and sigma.shape == (2,)
        assert bool(torch.isfinite(mu).all()) and bool((sigma > 0).all())
        assert bool(((mu - 21.0).abs() < 15.0).all()), mu  # raw units
        _close(mu, want[0], MODEL_TOL)
        _close(sigma, want[1], MODEL_TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_vit_tensor_parallel_matches_jax(n):
    cfg, params, imgs = _vit_case()
    blocks, rest = jvit.shard_params_tp(params, n)
    want = _jit(jvit.apply_tp, blocks, rest, cfg, imgs, _mesh(n, "model"), "model")
    _every_rank(n, "vit_tp", want, MODEL_TOL)
    _close(want, _jit(jvit.apply, params, cfg, imgs), MODEL_TOL)


def test_tp_rejects_nondivisible_degree():
    cfg = tvit.ViTConfig(image_size=16, patch_size=8, dim=32, depth=1, heads=4,
                         num_classes=4, dtype="float32")
    params = tvit.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        tvit.shard_params_tp(params, 3)  # 3 does not divide dim 32


@pytest.mark.parametrize("m", [2, 8])
def test_gpipe_pipeline_matches_jax(m):
    blocks, x = _gpipe_case()
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *blocks)

    def stage_fn(blk, act):
        return jcommon.transformer_block(blk, act, 4, dtype=jnp.float32)

    want = _jit(j_pipeline_apply, stacked, x, stage_fn, _mesh(4, "stage"), "stage",
                microbatches=m)
    _every_rank(4, f"gpipe_{m}", want, MODEL_TOL)


def test_gpipe_single_stage_degenerates():
    blk = jcommon.transformer_block_init(jax.random.PRNGKey(0), 16, 2)
    x = np.random.default_rng(2).standard_normal((4, 6, 16)).astype(np.float32)
    want = jcommon.transformer_block(blk, jnp.asarray(x), 2, dtype=jnp.float32)
    _every_rank(1, "gpipe_single", want, MODEL_TOL)


# -- the port's own checks ----------------------------------------------------------

def test_tp_slices_match_jax_shard_params_tp():
    """The port's per-rank slices are the JAX ``shard_params_tp``'s stacked
    leaves, bitwise (the row-parallel bias on rank 0 only)."""
    _, params, _ = _vit_case()
    for n in (2, 4):
        jblocks, jrest = jvit.shard_params_tp(params, n)
        blocks, rest = tvit.shard_params_tp(_port(params), n)
        paths = jax.tree_util.tree_flatten_with_path(jblocks)[0]
        assert len(paths) == len(tc.tree_leaves(blocks))
        for path, want in paths:
            got = blocks
            for key in path:
                got = got[key.idx if hasattr(key, "idx") else key.key]
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert sorted(rest) == sorted(jrest)


def test_tp_bias_on_every_rank_fault_fails():
    """A row-parallel bias on every rank (added 4 times across the psum)
    misses the reference by far more than the bar."""
    cfg, params, imgs = _vit_case()
    want = np.asarray(_jit(jvit.apply, params, cfg, imgs))
    got = _world(4)[0]["vit_tp_bias_fault"].numpy()
    assert not np.allclose(got, want, rtol=MODEL_TOL, atol=MODEL_TOL)
    assert np.abs(got - want).max() > 100 * MODEL_TOL


def _blocks_at(q_off, k_off, tl=12, seed=5):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((2, tl, 3, 8)).astype(np.float32) for _ in range(3))
    q_pos, k_pos = q_off + np.arange(tl), k_off + np.arange(tl)
    return q, k, v, q_pos[:, None] >= k_pos[None, :]


# the mask regimes of the causal ring: the diagonal block, a fully visible
# block (src < my), a fully masked one (src > my), unequal offsets in between
MASKED = [(24, 24), (24, 12), (12, 24), (17, 11), (11, 17)]


@pytest.mark.parametrize("q_off,k_off", MASKED)
def test_block_attn_plain_matches_jax(q_off, k_off):
    q, k, v, mask = _blocks_at(q_off, k_off)
    want = jra._block_attn(q, k, v, mask)  # eager, as the ring runs it
    got = tra.block_attn_plain(*map(torch.from_numpy, (q, k, v, mask)))
    for g, w in zip(got, want):
        _close(g, w, RING_TOL)
    if not mask.any():  # fully masked: the sentinel max, p = 0
        assert (got[0] == np.float32(tra.NEG_INF)).all() and not got[1].any()


def test_ring_logits_divide_as_the_reference():
    """The ring's logits are q.k DIVIDED by sqrt(hd): on small-integer q
    and k (every dot exact in any order) the row max is bitwise the eager
    reference's at hd 8, whose sqrt is not a power of two, and the product
    by 1/sqrt(hd) misses it on some rows."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.integers(-3, 4, (2, 16, 2, 8)).astype(np.float32) for _ in range(3))
    mask = np.ones((16, 16), bool)
    want = np.asarray(jra._block_attn(q, k, v, mask)[0])
    got = tra.block_attn_plain(*map(torch.from_numpy, (q, k, v, mask)))[0].numpy()
    np.testing.assert_array_equal(got, want)
    raw = torch.einsum("bqhd,bkhd->bhqk", torch.from_numpy(q), torch.from_numpy(k))
    assert not np.array_equal((raw * np.float32(1 / np.sqrt(8))).amax(-1).numpy(), want)


def _jax_step(q, k, v, mask, m, l, acc):
    bm, bl, bacc = jra._block_attn(q, k, v, mask)
    m_new = jnp.maximum(m, bm)
    r_old, r_blk = jnp.exp(m - m_new), jnp.exp(bm - m_new)
    return m_new, l * r_old + bl * r_blk, acc * r_old[..., None] + bacc * r_blk[..., None]


def test_masked_block_after_step_zero_is_bitwise_noop():
    """The combine with a fully masked block leaves m, l, acc bitwise as
    they were once a step has made m finite (the causal ring's diagonal
    comes first): what lets the kernel skip such blocks' arithmetic."""
    q, k, v, mask = _blocks_at(24, 24)
    state = [torch.full((2, 3, 12), tra.NEG_INF), torch.zeros((2, 3, 12)),
             torch.zeros((2, 3, 12, 8))]
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tra.ring_step_plain(tq, tk, tv, *state, 24, 24, True)
    before = [s.clone() for s in state]
    tra.ring_step_plain(tq, tk, tv, *state, 24, 36, True)  # src > my: fully masked
    for a, b in zip(state, before):
        assert torch.equal(a, b) and not a.isnan().any()
    want = _jax_step(q, k, v, mask, -1e30 * jnp.ones((2, 3, 12)), jnp.zeros((2, 3, 12)),
                     jnp.zeros((2, 3, 12, 8)))
    for a, w in zip(before, want):
        _close(a, w, RING_TOL)


def test_neg_inf_sentinel_fault_fails(monkeypatch):
    """With -inf for the mask's sentinel, a fully masked block on a fresh
    state gives exp(-inf - -inf) = NaN where the reference's -1e30 gives
    l = 0 and acc = 0."""
    q, k, v, mask = _blocks_at(12, 24)
    assert not mask.any()
    want = _jax_step(q, k, v, mask, -1e30 * jnp.ones((2, 3, 12)), jnp.zeros((2, 3, 12)),
                     jnp.zeros((2, 3, 12, 8)))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for neg, ok in ((tra.NEG_INF, True), (float("-inf"), False)):
        monkeypatch.setattr(tra, "NEG_INF", neg)
        state = [torch.full((2, 3, 12), neg), torch.zeros((2, 3, 12)), torch.zeros((2, 3, 12, 8))]
        tra.ring_step_plain(tq, tk, tv, *state, 12, 24, True)
        agree = all(np.allclose(s.numpy(), np.asarray(w), rtol=RING_TOL, atol=RING_TOL)
                    for s, w in zip(state, want))
        assert agree == ok, (neg, state)
    assert torch.isnan(state[1]).all()  # the fault's l


def test_entry_points_check_like_the_reference():
    """The reference's checks, before any collective: the context past
    cfg.context and a context the ranks do not split; stage and microbatch
    counts; the TP rank count; the head count a TP degree must divide."""
    axis = tdist.Axis(0, 4, "gloo", "cpu")
    cfg, params, normed = _tf_case(64)
    tp, pcfg = _port(params), _port_tf_cfg(cfg)
    with pytest.raises(ValueError, match="exceeds cfg.context"):
        ttf.backbone_sharded(tp, pcfg, torch.zeros((2, 68)), axis)
    with pytest.raises(ValueError, match="must divide across 4 ranks"):
        ttf.backbone_sharded(tp, pcfg, torch.zeros((2, 62)), axis)
    blocks, x = _gpipe_case()
    stacked = tc.tree_map(lambda *xs: torch.stack(xs), *[_port(b) for b in blocks[:3]])
    with pytest.raises(ValueError, match="3 stacked stages but 4 ranks"):
        tpp.pipeline_apply(stacked, torch.from_numpy(x), _stage(4), axis)
    stacked = tc.tree_map(lambda *xs: torch.stack(xs), *[_port(b) for b in blocks])
    with pytest.raises(ValueError, match="must divide into 3 microbatches"):
        tpp.pipeline_apply(stacked, torch.from_numpy(x), _stage(4), axis, microbatches=3)
    vcfg, vparams, imgs = _vit_case()
    blocks, rest = tvit.shard_params_tp(_port(vparams), 2)
    with pytest.raises(ValueError, match="sliced for 2 TP ranks"):
        tvit.apply_tp(blocks, rest, _port_vit_cfg(vcfg), torch.from_numpy(imgs), axis)
    with pytest.raises(ValueError, match="must divide head count 4"):
        tc.transformer_block_tp(tc.tree_map(lambda a: a[0], blocks[0]),
                                torch.zeros((1, 5, 32)), 4, tdist.Axis(0, 3, "gloo", "cpu"),
                                tvit.KERNEL_OPS)


def test_rank_exception_fails_the_run():
    """A rank that raises fails the whole run: the context does not split
    over 3 ranks, every rank raises, and run_ranks raises in the caller."""
    q, k, v = _qkv(t=64)
    job = tdist.Job("ring", tra.ring_attention, dict(q=q, k=k, v=v))
    with pytest.raises(Exception, match="does not split over 3 ranks"):
        tdist.run_ranks(tdist.run_jobs, 3, "gloo", "cpu", [job])


def test_backend_is_never_switched():
    with pytest.raises(ValueError, match="NCCL runs ranks on CUDA devices"):
        tdist.run_ranks(tdist.run_jobs, 1, "nccl", "cpu", [])
    with pytest.raises(ValueError, match="backend must be one of"):
        tdist.run_ranks(tdist.run_jobs, 1, "mpi", "cpu", [])
