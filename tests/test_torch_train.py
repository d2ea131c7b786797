"""Port parity of the continual-learning train lane for the recurrent
families: ``sitewhere_tpu_torch`` (the plain versions of KB, KR and KO on
the CPU) against the JAX package, on the same numpy inputs and param trees.

Bars, each the reference's own or stated here:

- the per-row loss, f32 compute: rtol 1e-5, atol 1e-6;
- f32 gradients of the masked per-slot mean, per element: rtol 1e-4, atol
  1e-5 (``tests/test_train_lane.py:119-124``);
- bf16 gradients: two bf16 computations do not agree per element, so each
  leaf's relative-norm error against the f32 gradient is held at 2e-2; the
  reference's own bf16 error is printed beside it (ROADMAP queue 3);
- Adam (``ops.adam``) against ``optax.scale_by_adam`` vmapped over the
  slots with the train step's epilogue, compiled as the reference's step
  is: bitwise over 5 steps (the port evaluates the FMAs and the folded
  division XLA compiles on the CPU);
- the scorers after 4 steps: losses rtol 1e-5 / atol 1e-6, params and Adam
  state rtol 1e-4 / atol 1e-5; after step 1, ``mu = 0.1 g`` and ``nu =
  0.001 g^2`` bitwise on the port's own gradient (Adam's first step is
  ``~sign(g)``, so params alone cannot show a wrong gradient);
- the feed rings after ``train_feed_ingest``: bitwise; the freeze of slots
  outside the mask: bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sitewhere_tpu.models as jm
import sitewhere_tpu.ops.windows as jw
import sitewhere_tpu.parallel.sharded as js
import sitewhere_tpu_torch.models as tm
import sitewhere_tpu_torch.models.common as tc
from sitewhere_tpu.parallel.mesh import MeshManager as JMesh
from sitewhere_tpu_torch.ops import adam
from sitewhere_tpu_torch.parallel.mesh import MeshManager
from sitewhere_tpu_torch.parallel.sharded import ShardedScorer

S, B, W, H = 3, 64, 32, 64
FAMILIES = ("lstm_ad", "deepar")
# the planes the loss and gradient tests run on, (slots, rows, window,
# hidden): the templated train forms' shape, and one wide shape a family,
# which routes to KB's and KR's wide forms on the card (a width that is no
# multiple of 8 or past 64, a window past 128), at 2 slots x 8 rows
BASE = (S, B, W, H)
WIDE = {"lstm_ad": (2, 8, 140, 12), "deepar": (2, 8, 136, 40)}
CASES = [pytest.param(f, BASE, id=f) for f in FAMILIES] + [
    pytest.param(f, sh, id=f"{f}-h{sh[3]}w{sh[2]}") for f, sh in WIDE.items()]

# tiny tensors: one intra-op thread, so the suite's parallel workers keep
# their cores
torch.set_num_threads(1)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _configs(family, dtype, window=W, hidden=H):
    over = {"window": window, "hidden": hidden, "dtype": dtype}
    return jm.make_config(family, over), tm.make_config(family, over)


def _stacked(family, seed, n=S, window=W, hidden=H):
    """n per-slot JAX param trees with non-zero biases, stacked, as numpy
    (DeepAR's sigma bias near -1, so sigma ranges over ~0.1..1)."""
    jcfg, _ = _configs(family, "float32", window, hidden)
    rng = np.random.default_rng(100 + seed)
    trees = []
    for i in range(n):
        p = _np_tree(jm.get_model(family).init(jax.random.PRNGKey(10 * seed + i), jcfg))
        for layer in p.values():
            layer["b"] = rng.normal(scale=0.1, size=layer["b"].shape).astype(np.float32)
        if family == "deepar":
            p["sigma"]["b"] -= 1.0
        trees.append(p)
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *trees)


def _plane(seed, n=S, b=B, window=W):
    """Random-walk windows f32[n, b, W] and a row mask: some cold rows,
    and slot 1 masked out."""
    rng = np.random.default_rng(seed)
    wins = np.cumsum(rng.normal(size=(n, b, window)), -1).astype(np.float32)
    mask = (rng.random((n, b)) < 0.8).astype(np.float32)
    mask[1] = 0.0
    return wins, mask


def _jax_grad(family, jcfg, stacked, wins, mask):
    spec = jm.get_model(family)

    def obj(p):
        per_row = spec.loss_stacked(p, jcfg, jnp.asarray(wins))
        m = jnp.asarray(mask)
        return ((per_row * m).sum(-1) / jnp.maximum(m.sum(-1), 1.0)).sum()

    return _np_tree(jax.jit(jax.grad(obj))(jax.tree_util.tree_map(jnp.asarray, stacked)))


def _port_grad(family, tcfg, stacked, wins, mask):
    spec = tm.get_model(family)
    m = torch.from_numpy(mask)

    def obj(p):
        per_row = spec.loss_stacked(p, tcfg, torch.from_numpy(wins))
        return ((per_row * m).sum(-1) / torch.clamp_min(m.sum(-1), 1.0)).sum()

    _, g = tc.value_and_grad(obj, tc.params_from_numpy(stacked, "cpu"))
    return tc.params_to_numpy(g)


def _pairs(a, b):
    return zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b))


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("family, shape", CASES)
def test_loss_stacked_matches_reference(family, shape):
    n, b, w, h = shape
    jcfg, tcfg = _configs(family, "float32", w, h)
    stacked = _stacked(family, 0, n, w, h)
    wins, _ = _plane(0, n, b, w)
    spec, jspec = tm.get_model(family), jm.get_model(family)
    want = np.asarray(jax.jit(jspec.loss_stacked, static_argnums=1)(
        stacked, jcfg, jnp.asarray(wins)))
    params = tc.params_from_numpy(stacked, "cpu")
    got = spec.loss_stacked(params, tcfg, torch.from_numpy(wins)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    plain = spec.loss_stacked_plain(params, tcfg, torch.from_numpy(wins)).numpy()
    np.testing.assert_array_equal(plain, got)
    # the legacy per-tenant loss of slot 0 is the mean of its rows
    one = jax.tree_util.tree_map(lambda x: x[0], stacked)
    legacy = float(spec.loss(tc.params_from_numpy(one, "cpu"), tcfg, torch.from_numpy(wins[0])))
    jl = jax.jit(jspec.loss, static_argnums=1)(one, jcfg, jnp.asarray(wins[0]))
    np.testing.assert_allclose(legacy, float(jl), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(legacy, float(want[0].mean()), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("family, shape", CASES)
def test_f32_gradients_match_reference(family, shape):
    n, b, w, h = shape
    jcfg, tcfg = _configs(family, "float32", w, h)
    stacked = _stacked(family, 0, n, w, h)
    wins, mask = _plane(1, n, b, w)
    want = _jax_grad(family, jcfg, stacked, wins, mask)
    got = _port_grad(family, tcfg, stacked, wins, mask)
    for g, w in _pairs(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    # the masked slot's gradient is exactly zero
    for g in jax.tree_util.tree_leaves(got):
        assert not np.any(g[1])


@pytest.mark.parametrize("family, shape, seed", [
    pytest.param(*c.values, seed, id=f"{c.id}-{seed}") for seed in (0, 1, 2) for c in CASES
    if seed == 0 or c.values[1] == BASE])
def test_bf16_gradients_accurate_against_f32(family, shape, seed):
    """The port's bf16 gradient, each leaf, within 2e-2 relative norm of
    the f32 gradient; the reference's own bf16 gradient's error is printed
    beside it (on DeepAR's head biases it is 1.4-11%, ROADMAP queue 3).
    The wide shapes run seed 0."""
    n, b, w, h = shape
    jcfg32, tcfg32 = _configs(family, "float32", w, h)
    jcfg16, tcfg16 = _configs(family, "bfloat16", w, h)
    stacked = _stacked(family, seed, n, w, h)
    wins, mask = _plane(10 + seed, n, b, w)
    ref32 = _jax_grad(family, jcfg32, stacked, wins, mask)
    ref16 = _jax_grad(family, jcfg16, stacked, wins, mask)
    got = _port_grad(family, tcfg16, stacked, wins, mask)
    names = ["/".join(str(getattr(k, "key", k)) for k in path)
             for path, _ in jax.tree_util.tree_leaves_with_path(ref32)]
    errs = {}
    for name, g, r16, r32 in zip(names, jax.tree_util.tree_leaves(got),
                                 jax.tree_util.tree_leaves(ref16),
                                 jax.tree_util.tree_leaves(ref32)):
        errs[name] = (_rel(g, r32), _rel(r16, r32))
    print(f"{family} seed {seed} bf16 grad rel-norm error (port, reference): {errs}")
    for name, (port, _) in errs.items():
        assert port <= 2e-2, (name, port)


def _optax_step(opt):
    @jax.jit
    def step(p, o, g, act, lr):
        up, o2 = jax.vmap(lambda g1, o1, p1: opt.update(g1, o1, p1))(g, o, p)
        sc = -1.0 * lr

        def apply(a, u):
            return (a + sc.reshape((-1,) + (1,) * (u.ndim - 1)) * u).astype(a.dtype)

        def keep(new, old):
            return jnp.where(act.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)

        p2 = jax.tree_util.tree_map(apply, p, up)
        return (jax.tree_util.tree_map(keep, p2, p), jax.tree_util.tree_map(keep, o2, o))

    return step


def test_adam_matches_optax_bitwise():
    """adam_update_plain against optax.scale_by_adam vmapped over 4 slots,
    the train step's per-slot lr and freeze, compiled: 5 steps with mixed
    active slots, gradients over 8 decades; params, mu, nu, count bitwise."""
    rng = np.random.default_rng(3)
    stacked = _stacked("lstm_ad", 1, n=4, window=8, hidden=8)
    opt = optax.scale_by_adam()
    jp = jax.tree_util.tree_map(jnp.asarray, stacked)
    jo = jax.vmap(opt.init)(jp)
    tp = tc.params_from_numpy(stacked, "cpu")
    to = adam.init_adam(tp, 4)
    lr = np.array([1e-3, 3e-2, 0.5, 1e-4], np.float32)
    step = _optax_step(opt)
    for i in range(5):
        g = jax.tree_util.tree_map(
            lambda x: (rng.normal(size=x.shape) * 10.0 ** rng.uniform(-6, 2, size=x.shape))
            .astype(np.float32), stacked)
        act = np.array([True, i % 2 == 0, True, False])
        jp, jo = step(jp, jo, jax.tree_util.tree_map(jnp.asarray, g), jnp.asarray(act),
                      jnp.asarray(lr))
        adam.adam_update_plain(tp, tc.params_from_numpy(g, "cpu"), to, torch.from_numpy(lr),
                               torch.from_numpy(act))
        for a, b in _pairs(tc.params_to_numpy(tp), jp):
            np.testing.assert_array_equal(a, np.asarray(b))
        mine = tc.opt_state_to_numpy(to)
        np.testing.assert_array_equal(mine.count, np.asarray(jo.count))
        for a, b in _pairs((mine.mu, mine.nu), (jo.mu, jo.nu)):
            np.testing.assert_array_equal(a, np.asarray(b))
    assert list(np.asarray(jo.count)) == [5, 3, 5, 0]


@pytest.mark.parametrize("family", FAMILIES)
def test_legacy_train_step_matches_reference(family):
    """The legacy per-tenant ``loss``'s gradient per element, then one
    ``train_step`` with ``scale_by_adam`` (its unit-size first step moves
    each param by ~1, so later steps amplify any last-ulp difference: one
    step is held)."""
    jcfg, tcfg = _configs(family, "float32", window=12, hidden=8)
    one = jax.tree_util.tree_map(lambda x: x[0], _stacked(family, 2, n=1, window=12, hidden=8))
    wins = np.cumsum(np.random.default_rng(4).normal(size=(8, 12)), -1).astype(np.float32)
    jspec, spec = jm.get_model(family), tm.get_model(family)
    jl, jg = jax.jit(jax.value_and_grad(jspec.loss), static_argnums=1)(
        one, jcfg, jnp.asarray(wins))
    tl, tg = tc.value_and_grad(lambda p: spec.loss(p, tcfg, torch.from_numpy(wins)),
                               tc.params_from_numpy(one, "cpu"))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-6)
    for a, b in _pairs(tc.params_to_numpy(tg), jg):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)
    opt, port = optax.scale_by_adam(), adam.scale_by_adam()
    jp, jo, jl = jax.jit(jspec.train_step, static_argnums=(3, 4))(
        one, opt.init(one), jnp.asarray(wins), jcfg, opt)
    tp = tc.params_from_numpy(one, "cpu")
    tp, to, tl = spec.train_step(tp, port.init(tp), torch.from_numpy(wins), tcfg, port)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-6)
    for a, b in _pairs(tc.params_to_numpy(tp), jp):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)
    assert int(to.count) == int(jo.count) == 1


# -- the scorers -----------------------------------------------------------------

T, STREAMS, SW, SH = 4, 16, 8, 8


def _scorers(family, window=SW, hidden=SH):
    """The reference scorer on one CPU device and the port's, sharing the
    reference's base params: slots 0-2 active, slot 2 not trainable, slots
    0 and 1 at their own lr; f32 compute (the reference's own train-lane
    bars). The lrs are ones a tenant sets (the default 1.0 makes each Adam
    step move every param by ~1, which turns a last-ulp difference of two
    right gradients into a visible one by the next step)."""
    jcfg, tcfg = _configs(family, "float32", window=window, hidden=hidden)
    jsc = js.ShardedScorer(JMesh(tenant=1, data=1, devices=jax.devices()[:1]),
                           jm.get_model(family), jcfg, slots_per_shard=T,
                           max_streams=STREAMS, window=window)
    base = _np_tree(jsc._base_params)
    tsc = ShardedScorer(MeshManager(device="cpu"), tm.get_model(family), tcfg,
                        slots_per_shard=T, max_streams=STREAMS, window=window, base_params=base)
    for sc in (jsc, tsc):
        sc.activate(0, trainable=True, lr=1e-3)
        sc.activate(1, trainable=True, lr=3e-3)
        sc.activate(2, trainable=False)
    return jsc, tsc


def _warm(scorer, rounds=14, seed=7):
    """``tests/test_train_lane.py:86``'s traffic: streams 0 and 1 of every
    slot, four rows a round."""
    for i in range(rounds):
        rng = np.random.default_rng(seed + i)
        ids = np.zeros((T, 4), scorer.ids_np_dtype)
        vals = np.zeros((T, 4), np.float32)
        counts = np.zeros((T, 1), np.int32)
        for ti in range(T):
            ids[ti, :4] = [0, 1, 0, 1]
            vals[ti, :4] = rng.normal(size=4)
            counts[ti, 0] = 4
        scorer.step_counts(*scorer.stage_inputs(ids, vals, counts))


def _assert_train_state(jsc, tsc):
    for a, b in _pairs(tc.params_to_numpy(tsc.params), jsc.params):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)
    mine = tc.opt_state_to_numpy(tsc._opt_state)
    np.testing.assert_array_equal(mine.count, np.asarray(jsc._opt_state.count))
    for a, b in _pairs((mine.mu, mine.nu), (jsc._opt_state.mu, jsc._opt_state.nu)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("family, window, hidden", [
    pytest.param(f, SW, SH, id=f) for f in FAMILIES] + [
    pytest.param(f, sh[2], sh[3], id=f"{f}-h{sh[3]}w{sh[2]}") for f, sh in WIDE.items()])
def test_scorer_train_steps_match_reference(family, window, hidden):
    """``train_lane_step`` x3 and ``train_resident`` x1 on the same warmed
    window state: losses, params, mu, nu, count at the reference's bars;
    after step 1, mu = 0.1 g and nu = 0.001 g^2 bitwise on the port's own
    gradient of the masked per-slot mean; the untrainable slot frozen. Also
    at each family's wide shape (the wide train forms' route on the card),
    where the warmed streams' windows are mostly left-padded."""
    jsc, tsc = _scorers(family, window, hidden)
    for sc in (jsc, tsc):
        _warm(sc)
        sc.init_optimizer()
    frozen = tc.params_to_numpy(tsc.slot_params(2))
    mask = torch.tensor([1.0, 1.0, 0.0, 0.0])
    rows = (tsc.state.count.clamp(max=window) >= min(window, 8)).float() * mask[:, None]
    spec = tm.get_model(family)

    def obj(p):
        per_row = spec.loss_stacked(p, tsc.cfg, tm.train.ring_windows(tsc.state))
        return ((per_row * rows).sum(-1) / torch.clamp_min(rows.sum(-1), 1.0)).sum()

    _, g = tc.value_and_grad(obj, tsc.params)
    for step in range(4):
        if step < 3:
            lj, lt = jsc.train_lane_step(), tsc.train_lane_step()
        else:
            lj, lt = jsc.train_resident(), tsc.train_resident()
        np.testing.assert_allclose(np.asarray(lt), np.asarray(lj), rtol=1e-5, atol=1e-6)
        if step == 0:
            opt = tsc._opt_state
            for gl, m, v in zip(*(tc.tree_leaves(x) for x in (g, opt.mu, opt.nu))):
                np.testing.assert_array_equal(m[:2].numpy(), (np.float32(0.1) * gl[:2]).numpy())
                np.testing.assert_array_equal(
                    v[:2].numpy(), (np.float32(0.001) * (gl[:2] * gl[:2])).numpy())
        _assert_train_state(jsc, tsc)
    assert list(tsc._opt_state.count.numpy()) == [4, 4, 0, 0]
    assert float(np.asarray(lt)[0]) > 0
    for a, b in _pairs(tc.params_to_numpy(tsc.slot_params(2)), frozen):
        np.testing.assert_array_equal(a, b)


def _feed(rng, ids_dtype, burst: bool):
    """One replay microbatch [T, 24]: 6 of the first 8 streams, at most 3
    rows each (no stream past the window), or with ``burst`` stream 3
    taking 12 rows (past W = 8) after shorter runs."""
    ids = np.zeros((T, 24), ids_dtype)
    vals = rng.normal(size=(T, 24)).astype(np.float32)
    counts = np.zeros((T, 1), np.int32)
    for t in range(T):
        k = int(rng.integers(6, 19))
        rows = np.repeat(rng.choice(8, 6, replace=False), 3)
        if burst:
            rows = np.concatenate([[0, 0, 5], np.full(12, 3), [5, 9, 9]])
        ids[t, :k] = rng.permutation(rows)[:k] if not burst else rows[:k]
        counts[t, 0] = k
    return ids, vals, counts


@pytest.mark.parametrize("family", FAMILIES)
def test_train_feed_ingest_matches_reference(family):
    """``train_feed_ingest`` (KW in counts mode) against the reference's
    ``_ingest``: feed rings bitwise over 8 microbatches where no stream
    passes W rows; then one replay step, held at the reference's bars."""
    jsc, tsc = _scorers(family)
    rng = np.random.default_rng(11)
    for sc in (jsc, tsc):
        sc.init_optimizer()
    for _ in range(8):
        ids, vals, counts = _feed(rng, tsc.ids_np_dtype, burst=False)
        jsc.train_feed_ingest(*jsc.stage_inputs(ids, vals, counts))
        tsc.train_feed_ingest(*tsc.stage_inputs(ids, vals, counts))
        for a, b in zip(tsc._train_feed_state, jsc._train_feed_state):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    lj, lt = jsc.train_lane_step(replay=True), tsc.train_lane_step(replay=True)
    np.testing.assert_allclose(np.asarray(lt), np.asarray(lj), rtol=1e-5, atol=1e-6)
    assert np.asarray(lt)[:2].min() > 0
    _assert_train_state(jsc, tsc)
    # the serve rings were not touched
    assert int(tsc.state.count.sum()) == 0


def test_train_feed_ingest_burst_matches_per_stream_counts():
    """A stream past W rows in one microbatch (config 8's 4096-row
    microbatches put ~128 rows of a stream into one ingest): the feed rings
    equal the reference's ``_apply_update`` driven with per-stream counts
    (the documented contract; the reference's ``_segment_ranks`` fault,
    ROADMAP queue 3, would drop rows here)."""
    _, tsc = _scorers("lstm_ad")
    rng = np.random.default_rng(12)
    want = jw.init_window_state(STREAMS, SW)
    want = [want] * T
    for _ in range(2):
        ids, vals, counts = _feed(rng, np.int32, burst=True)
        tsc.train_feed_ingest(ids, vals, counts)
        for t in range(T):
            k = counts[t, 0]
            valid = np.arange(24) < k
            keys = np.where(valid, ids[t], -1)
            ranks = np.zeros(24, np.int32)
            totals = np.zeros(24, np.int32)
            for s_id in np.unique(keys[valid]):
                at = np.flatnonzero(keys == s_id)
                ranks[at] = np.arange(len(at))
                totals[at] = len(at)
            want[t] = jw._apply_update(want[t], jnp.asarray(ids[t]), jnp.asarray(vals[t]),
                                       jnp.asarray(valid), jnp.asarray(ranks),
                                       jnp.asarray(totals))
    for name, got in zip(("values", "pos", "count"), tsc._train_feed_state):
        ref = np.stack([np.asarray(getattr(w, name)) for w in want])
        np.testing.assert_array_equal(got.numpy(), ref)
    assert int(tsc._train_feed_state.count[:, 3].max()) == 24


@pytest.mark.parametrize("family", FAMILIES)
def test_all_false_mask_step_and_reset_slot(family):
    """An all-False ``slots_mask`` step passes params and Adam state through
    bitwise; ``reset_slot`` wipes the slot's params, moments, count and
    feed rings and leaves the others."""
    _, tsc = _scorers(family)
    _warm(tsc)
    tsc.init_optimizer()
    tsc.prewarm_train_lane([8])
    tsc.train_feed_ingest(*_feed(np.random.default_rng(2), tsc.ids_np_dtype, False))
    tsc.train_lane_step()
    before = tc.params_to_numpy(tsc.params), tc.opt_state_to_numpy(tsc._opt_state)
    losses = tsc.train_lane_step(slots_mask=np.zeros(T, bool))
    assert not np.asarray(losses).any()
    after = tc.params_to_numpy(tsc.params), tc.opt_state_to_numpy(tsc._opt_state)
    for a, b in _pairs(after, before):
        np.testing.assert_array_equal(a, b)
    base = tc.params_to_numpy(tsc._base_params)
    tsc.reset_slot(0)
    assert not bool(tsc.active[0]) and not bool(tsc.train_mask[0])
    assert float(tsc.slot_lr[0]) == 1.0
    opt = tc.opt_state_to_numpy(tsc._opt_state)
    assert opt.count[0] == 0 and opt.count[1] == 1
    for a in jax.tree_util.tree_leaves((opt.mu, opt.nu)):
        assert not a[0].any() and a[1].any()
    for a, b in _pairs(tc.params_to_numpy(tsc.slot_params(0)), base):
        np.testing.assert_array_equal(a, b)
    for x in tsc._train_feed_state:
        assert not x[0].any()
    assert tsc._train_feed_state.count[1].any()


def test_optimizer_surface_raises_where_not_ported():
    _, tsc = _scorers("lstm_ad")
    with pytest.raises(NotImplementedError):
        tsc.init_optimizer(optimizer=optax.scale_by_adam())
    with pytest.raises(RuntimeError):
        tsc.train_lane_step()
    tsc.init_optimizer()
    with pytest.raises(RuntimeError):
        tsc.train_lane_step(replay=True)
    # a family with no train form raises (the transformer has one since its
    # training slice; the ViT's comes later)
    over = {"context": 8, "dim": 16, "depth": 1, "heads": 2, "dtype": "float32"}
    bare = dataclasses.replace(tm.get_model("transformer"), loss_ring=None,
                               loss_stacked_plain=None)
    tf = ShardedScorer(MeshManager(device="cpu"), bare, tm.make_config("transformer", over),
                       slots_per_shard=2, max_streams=8, window=8)
    with pytest.raises(NotImplementedError):
        tf.init_optimizer()
    assert tm.get_model("transformer").loss_stacked is not None
    assert tm.get_model("vit_b16").loss_stacked is None


@pytest.mark.parametrize("family", FAMILIES)
def test_slot_opt_state_round_trips_the_reference(family):
    """The reference's ``slot_opt_state`` (after two steps) into the port's
    ``restore_slot_opt`` and back out of ``slot_opt_state``: bitwise; the
    stacked layout (``jax.vmap(optimizer.init)``'s) carries across too."""
    jsc, tsc = _scorers(family)
    _warm(jsc)
    jsc.init_optimizer()
    jsc.train_lane_step()
    jsc.train_lane_step()
    tsc.init_optimizer()
    saved = jsc.slot_opt_state(1)
    tsc.restore_slot_opt(3, saved)
    back = tsc.slot_opt_state(3)
    assert back.count.dtype == np.int32 and int(back.count) == 2
    for a, b in _pairs(back, saved):
        np.testing.assert_array_equal(a, np.asarray(b))
    stacked = tc.opt_state_from_numpy(jsc._opt_state, "cpu")
    for a, b in _pairs(tc.opt_state_to_numpy(stacked), jsc._opt_state):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert tsc.slot_opt_state(0).count == 0
