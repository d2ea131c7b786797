"""Port parity: ring-buffer windows (``sitewhere_tpu_torch.ops.windows``,
the plain versions of kernel KW and of KS's gather) against the JAX
package's ``sitewhere_tpu.ops.windows`` on identical numpy inputs.

Integer and scatter ops, so every comparison is bitwise. The port's
per-stream totals follow the reference's documented contract; the
reference's ``_segment_ranks`` broadcasts a suffix maximum instead (ROADMAP
queue 3), so the scatter is held against the reference's own
``_apply_update`` driven with the contract's totals, and the fault itself is
pinned below."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sitewhere_tpu.ops.windows as jw
import sitewhere_tpu_torch.ops.windows as tw

S, W, B = 16, 5, 24

# tiny tensors: one intra-op thread, so the suite's parallel workers keep
# their cores
torch.set_num_threads(1)


def _np(x):
    return np.asarray(x)


def _true_ranks_totals(keys):
    """Contract oracle: arrival rank among equal keys, and the key count."""
    ranks = np.zeros(len(keys), np.int32)
    totals = np.zeros(len(keys), np.int32)
    seen = {}
    for i, k in enumerate(keys.tolist()):
        ranks[i] = seen.get(k, 0)
        seen[k] = ranks[i] + 1
    for i, k in enumerate(keys.tolist()):
        totals[i] = seen[k]
    return ranks, totals


def _flush(rng, id_dtype, burst):
    """One batch: a few streams (so bursts repeat ids), ~25% invalid rows
    whose ids are stale leftovers (any id, in or out of range)."""
    ids = rng.integers(0, 6, B)
    if burst:
        ids[: W + 3] = 4          # one stream bursts past the window
        ids[W + 3] = S + 3        # an out-of-range id on a valid row
    valid = rng.random(B) > 0.25
    stale = rng.integers(0, S + 8, B)
    ids = np.where(valid, ids, stale).astype(id_dtype)
    vals = rng.normal(size=B).astype(np.float32)
    return ids, vals, valid


def test_segment_ranks_ranks_match_reference_and_totals_are_counts():
    rng = np.random.default_rng(0)
    for _ in range(5):
        keys = np.where(rng.random(64) > 0.2, rng.integers(0, 9, 64), -1)
        ranks, totals = tw._segment_ranks(torch.from_numpy(keys))
        jr, _ = jw._segment_ranks(jnp.asarray(keys, jnp.int32))
        want_r, want_t = _true_ranks_totals(keys)
        np.testing.assert_array_equal(ranks.numpy(), _np(jr))
        np.testing.assert_array_equal(ranks.numpy(), want_r)
        np.testing.assert_array_equal(totals.numpy(), want_t)


def test_reference_segment_totals_fault_is_pinned():
    """ROADMAP queue 3: the reference's totals are the longest run of the
    sorted suffix, not the stream's count. Stream 0 (2 rows) sorts before
    stream 1 (5 rows) and gets 5. The port gives 2."""
    keys = np.array([0, 0, 1, 1, 1, 1, 1], np.int32)
    _, jt = jw._segment_ranks(jnp.asarray(keys))
    _, tt = tw._segment_ranks(torch.from_numpy(keys))
    np.testing.assert_array_equal(_np(jt), [5, 5, 5, 5, 5, 5, 5])
    np.testing.assert_array_equal(tt.numpy(), [2, 2, 5, 5, 5, 5, 5])


@pytest.mark.parametrize("id_dtype", [np.int32, np.uint16])
def test_update_gather_chained_bitwise(id_dtype):
    """update_windows / gather_windows / update_gather_ranked over chained
    flushes with bursts past W, invalid rows, stale and out-of-range ids:
    state, windows, n and later bitwise equal to the reference's scatter
    and gather, and the windows equal a sequential append oracle."""
    rng = np.random.default_rng(1)
    jst = jw.init_window_state(S, W)
    tst = tw.init_window_state(S, W, device="cpu")
    history = {s: [] for s in range(S)}
    for f in range(6):
        ids, vals, valid = _flush(rng, id_dtype, burst=f % 2 == 1)
        ids32 = ids.astype(np.int32)
        keys = np.where(valid, ids32, -1)
        want_r, want_t = _true_ranks_totals(keys)
        jst = jw._apply_update(
            jst, jnp.asarray(ids32), jnp.asarray(vals), jnp.asarray(valid),
            jnp.asarray(want_r), jnp.asarray(want_t),
        )
        jwin, jn = jw.gather_windows(jst, jnp.asarray(ids32))
        t_ids = torch.from_numpy(ids.view(np.int16)).view(torch.uint16) \
            if id_dtype == np.uint16 else torch.from_numpy(ids)
        t_new, twin, tn, tlater = tw.update_gather_ranked(
            tst, t_ids, torch.from_numpy(vals), torch.from_numpy(valid)
        )
        plain = tw.update_windows(
            tst, t_ids, torch.from_numpy(vals), torch.from_numpy(valid)
        )
        tst = t_new
        for a, b in zip(tst, jst):
            np.testing.assert_array_equal(a.numpy(), _np(b))
        for a, b in zip(plain, jst):
            np.testing.assert_array_equal(a.numpy(), _np(b))
        np.testing.assert_array_equal(twin.numpy(), _np(jwin))
        np.testing.assert_array_equal(tn.numpy(), _np(jn))
        np.testing.assert_array_equal(
            tlater.numpy(), np.where(valid, want_t - 1 - want_r, 0)
        )
        for i in np.flatnonzero(valid):
            if ids32[i] < S:
                history[int(ids32[i])].append(float(vals[i]))
        for s in range(S):
            h = history[s][-W:]
            w, n = tw.gather_windows(tst, torch.tensor([s], dtype=torch.int32))
            assert int(n[0]) == len(h)
            if h:
                np.testing.assert_array_equal(
                    w[0].numpy(), np.array([h[0]] * (W - len(h)) + h, np.float32)
                )


def test_update_and_gather_matches_reference_without_bursts():
    """Batches whose streams hold at most W rows: the reference's own
    update_and_gather (its sort and all) agrees bitwise end to end."""
    rng = np.random.default_rng(2)
    jst = jw.init_window_state(S, W)
    tst = tw.init_window_state(S, W, device="cpu")
    for _ in range(4):
        ids = rng.permutation(np.repeat(np.arange(8), 3)).astype(np.int32)
        vals = rng.normal(size=len(ids)).astype(np.float32)
        valid = rng.random(len(ids)) > 0.2
        jst, jwin, jn = jw.update_and_gather(
            jst, jnp.asarray(ids), jnp.asarray(vals), jnp.asarray(valid)
        )
        tst, twin, tn = tw.update_and_gather(
            tst, torch.from_numpy(ids), torch.from_numpy(vals),
            torch.from_numpy(valid),
        )
        for a, b in zip(tst, jst):
            np.testing.assert_array_equal(a.numpy(), _np(b))
        np.testing.assert_array_equal(twin.numpy(), _np(jwin))
        np.testing.assert_array_equal(tn.numpy(), _np(jn))


@pytest.mark.parametrize("mode", ["counts", "mask"])
def test_window_update_stacked_in_place(mode):
    """KW's plain version updates every slot of the stacked state in place
    and equals the single-slot functional update per slot; bf16/f16 values
    widen exactly."""
    rng = np.random.default_rng(3)
    t = 3
    st = tw.init_window_state(S, W, device="cpu", n_slots=t)
    values_ptr = st.values.data_ptr()
    ref = [tw.init_window_state(S, W, device="cpu") for _ in range(t)]
    for f, vdt in enumerate((torch.float32, torch.bfloat16, torch.float16)):
        ids = rng.integers(0, 6, (t, B)).astype(np.uint16)
        ids[:, 20:] = S + 1  # stale padding past every lane count
        vals = torch.from_numpy(rng.normal(size=(t, B)).astype(np.float32)).to(vdt)
        counts = np.array([[20], [7], [0]], np.int32)
        valid = np.arange(B)[None, :] < counts
        t_ids = torch.from_numpy(ids.view(np.int16)).view(torch.uint16)
        if mode == "counts":
            later = tw.window_update(st, t_ids, vals, counts=torch.from_numpy(counts))
        else:
            later = tw.window_update(st, t_ids, vals, mask=torch.from_numpy(valid))
        for s in range(t):
            ref[s], _, _, want_later = tw.update_gather_ranked(
                ref[s], t_ids[s], vals[s], torch.from_numpy(valid[s])
            )
            for a, b in zip(st, ref[s]):
                np.testing.assert_array_equal(a[s].numpy(), b.numpy())
            np.testing.assert_array_equal(later[s].numpy(), want_later.numpy())
    assert st.values.data_ptr() == values_ptr  # updated in place
