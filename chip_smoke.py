#!/usr/bin/env python3
"""Drive the port's paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py          # from the repository root, one card

What it does, in order (each phase prints JSON records, one per line):

1. the card (``nvidia-smi`` name and power limit) and the torch, CUDA and
   nvcc versions;
2. builds the six CUDA kernels of ``sitewhere_tpu_torch/csrc`` from the
   checkout (nvcc, into ``sitewhere_tpu_torch/_build/``);
3. kernel phases: each kernel and its plain PyTorch version called on the
   same inputs on the card, held together (KW, KH, KG bitwise; KS, KD, KF
   within the bf16 bar 2e-2) and timed with CUDA events, beside the least
   time the card could take. Shapes: the repo's two LSTM-AD engine
   configurations, ``tenants32`` (32 tenant slots x 2048 rows, 8192
   streams a slot) and ``lstm_engine`` (1 slot x 16384 rows, 16384
   streams), and ``forecasting32`` (the shapes of ``tenants32`` with the
   ``forecasting`` tenant template's DeepAR family; KW, KD, KH, KG), all
   window 32, hidden 64, f32 params, bf16 compute, f32 wire, K=1; and
   ``deepar_replay`` (BASELINE config 3: 128 windows of context 128 cut
   from 64 series of 256 points, 64 samples, horizon 24; KF);
4. the main paths, every kernel's launch count set to 0 just before each
   and read just after:
   a. LSTM-AD scoring: tenant streams with Zipf-like repeats go through
      ``StreamRegistry`` -> ``_LaneRing`` -> rotating ``_StagingSet``s ->
      ``stage_inputs`` -> ``step_counts`` -> ``gather_rows`` -> async d2h,
      8 flushes at ``tenants32`` with all 32 slots active plus 3 on the
      bf16 wire (KW, KS, KH, KG);
   b. DeepAR scoring, the same protocol at ``forecasting32``, 4 flushes
      plus 2 on the bf16 wire (KW, KD, KH, KG);
   c. DeepAR forecasting: ``get_model("deepar").forecast`` on the
      ``deepar_replay`` windows with a seeded generator (KF).
   Each scoring drive checks that every fed row resolves exactly once with
   a finite score, that the sketch equals the np.histogram oracle, and that
   window state (bitwise) and scores (bf16 bar) match a plain-version
   scorer on the card fed the same flushes.

The last two lines are the ``kernels`` record (``launches`` summed over the
main-path drives; the other numbers from the kernel phases) and
``{"ok": true, "device": {...}}``. Any failed check raises, and the script
exits non-zero; without a CUDA device, or without the repository beside it,
it exits non-zero before printing a result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, bf16 tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
TOL = 2e-2  # the reference's bf16 bar (tests/test_fused_step.py:110)

SHAPES = {
    # name: (slots, rows per slot, streams per slot) — bench.py:2096, :2105;
    # forecasting32: tenants32 with the forecasting template's family
    # (sitewhere_tpu/runtime/config.py:341)
    "tenants32": (32, 2048, 8192),
    "lstm_engine": (1, 16384, 16384),
    "forecasting32": (32, 2048, 8192),
}
WINDOW, HIDDEN = 32, 64
# deepar_replay, BASELINE config 3 as bench.py:2131-2135 runs it
REPLAY_SERIES, REPLAY_CONTEXT, REPLAY_POINTS = 64, 128, 256
REPLACES = {
    "window_update": "sitewhere_tpu/ops/windows.py:66",
    "lstm_score": "sitewhere_tpu/models/lstm_ad.py:117",
    "gru_score": "sitewhere_tpu/models/deepar.py:97",
    "deepar_forecast": "sitewhere_tpu/models/deepar.py:206",
    "score_sketch": "sitewhere_tpu/parallel/sharded.py:511",
    "gather_rows": "sitewhere_tpu/parallel/sharded.py:415",
}
# the family's flush-form kernel
SCORER = {"lstm_ad": "lstm_score", "deepar": "gru_score"}


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def zipf_ids(rng, n_streams: int, size, a: float = 1.3) -> np.ndarray:
    """Stream ids with Zipf-like repeats (a few hot streams burst)."""
    perm = rng.permutation(n_streams)
    return perm[(rng.zipf(a, size) - 1) % n_streams]


# -- phase 3: each kernel against its plain version -----------------------------

def kernel_phase(shape: str, dev, spec, cfg, params) -> dict:
    """KW, the family's scorer (KS or KD), KH and KG at ``shape``."""
    import torch

    from sitewhere_tpu_torch.models.common import sketch_edges
    from sitewhere_tpu_torch.ops.windows import (
        WindowState, window_update, window_update_plain,
    )
    from sitewhere_tpu_torch.parallel.sharded import (
        gather_rows, gather_rows_plain, score_sketch, score_sketch_plain,
    )

    t, b, s = SHAPES[shape]
    rng = np.random.default_rng(7)
    gen = torch.Generator(device=dev).manual_seed(7)
    base = WindowState(
        torch.randn((t, s, WINDOW), generator=gen, device=dev),
        torch.randint(0, WINDOW, (t, s), generator=gen, device=dev, dtype=torch.int32),
        torch.randint(0, 2 * WINDOW, (t, s), generator=gen, device=dev, dtype=torch.int32),
    )
    ids_np = zipf_ids(rng, s, (t, b)).astype(np.uint16)
    ids = torch.from_numpy(ids_np.view(np.int16)).to(dev).view(torch.uint16)
    vals = torch.from_numpy(rng.normal(size=(t, b)).astype(np.float32)).to(dev)
    counts = torch.full((t, 1), b, dtype=torch.int32, device=dev)
    active = torch.ones((t,), dtype=torch.bool, device=dev)
    edges = torch.from_numpy(sketch_edges()).to(dev)
    params_t = {k: {x: v[:t].contiguous() for x, v in n.items()} for k, n in params.items()}

    def clone(st):
        return WindowState(*(x.clone() for x in st))

    out = {}
    # KW
    st_k, st_p = clone(base), clone(base)
    later_k = window_update(st_k, ids, vals, counts=counts)
    later_p = window_update_plain(st_p, ids, vals, counts=counts)
    torch.cuda.synchronize()
    check(torch.equal(later_k, later_p), f"{shape} KW later bitwise")
    for name, a, c in zip(("values", "pos", "count"), st_k, st_p):
        check(torch.equal(a, c), f"{shape} KW {name} bitwise")
    scratch = clone(base)
    kw_ms = cuda_time_ms(lambda: window_update(scratch, ids, vals, counts=counts), 20)
    scratch = clone(base)
    kw_plain_ms = cuda_time_ms(lambda: window_update_plain(scratch, ids, vals, counts=counts), 3, 1)
    # bytes the data needs: ids, values, counts and later once; pos/count
    # read and written per touched stream; the ring words that are written
    per_stream = np.unique(
        ids_np.astype(np.int64) + np.arange(t)[:, None] * 65536, return_counts=True
    )[1]
    uniq = len(per_stream)
    ring_writes = int(np.minimum(per_stream, WINDOW).sum())
    kw_bytes = t * b * (2 + 4 + 4) + t * 4 + uniq * 16 + ring_writes * 4
    out["window_update"] = dict(
        max_abs_err=0.0, ms=kw_ms, plain_ms=kw_plain_ms,
        bound_ms=kw_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=None,
    )
    # the scorer (on the post-update state both versions agree on)
    name, score, score_plain = SCORER[spec.name], spec.score_flush, spec.score_flush_plain
    sc_k = score(params_t, cfg, st_k, ids, later_k, active, counts=counts)
    sc_p = score_plain(params_t, cfg, st_p, ids, later_p, active, counts=counts)
    torch.cuda.synchronize()
    err = float((sc_k - sc_p).abs().max())
    check(bool(torch.isfinite(sc_k).all()), f"{shape} {name} finite")
    check(bool(torch.allclose(sc_k, sc_p, rtol=TOL, atol=TOL)),
          f"{shape} {name} within {TOL} (max abs err {err})")
    check(bool((sc_k != 0).any()), f"{shape} {name} scored")
    ks_ms = cuda_time_ms(lambda: score(params_t, cfg, st_k, ids, later_k, active, counts=counts), 10)
    ks_plain_ms = cuda_time_ms(
        lambda: score_plain(params_t, cfg, st_p, ids, later_p, active, counts=counts), 3, 1)
    live = t * b
    ks_flops = live * spec.flops_per_row(cfg, WINDOW, k=1)
    n_params = sum(v.numel() for n in params_t.values() for v in n.values())
    ks_bytes = t * b * (2 + 4 + 4) + t * 5 + uniq * (WINDOW * 4 + 8) + n_params * 4
    peak = BF16_FLOPS if cfg.dtype == "bfloat16" else F32_FLOPS
    ks_bound = max(ks_flops / peak, ks_bytes / HBM_BYTES_PER_S) * 1e3
    out[name] = dict(
        max_abs_err=err, ms=ks_ms, plain_ms=ks_plain_ms, bound_ms=ks_bound,
        bound_by="operations" if ks_flops / peak > ks_bytes / HBM_BYTES_PER_S else "bytes",
        library_ms=None, flops=ks_flops, negative_scores=int((sc_k < 0).sum()),
    )
    if spec.name == "deepar":
        # a measurement, not a check: the bf16 NLL's conditioning. With the
        # odd slots' sigma head biased by -2 (sigma ~0.13) a one-ulp flip of
        # the bf16 head output moves the NLL by ~3%, past the 2e-2 bar
        shifted = {k: dict(n) for k, n in params_t.items()}
        shifted["sigma"]["b"] = params_t["sigma"]["b"] - 2.0 * (torch.arange(t, device=dev) % 2)[:, None]
        a = score(shifted, cfg, st_k, ids, later_k, active, counts=counts)
        c = score_plain(shifted, cfg, st_p, ids, later_p, active, counts=counts)
        out[name]["small_sigma"] = dict(
            rows_outside_bar=int((~torch.isclose(a, c, rtol=TOL, atol=TOL)).sum()),
            max_abs_err=float((a - c).abs().max()), negative_scores=int((c < 0).sum()),
        )
    # KH (both versions on the kernel's scores)
    h_k = score_sketch(sc_k, active, edges, counts=counts)
    h_p = score_sketch_plain(sc_k, active, edges, counts=counts)
    torch.cuda.synchronize()
    check(torch.equal(h_k, h_p), f"{shape} KH bitwise")
    check(int(h_k.sum()) == t * b - int(torch.isnan(sc_k).sum()), f"{shape} KH counts every row")
    kh_ms = cuda_time_ms(lambda: score_sketch(sc_k, active, edges, counts=counts), 50)
    kh_plain_ms = cuda_time_ms(lambda: score_sketch_plain(sc_k, active, edges, counts=counts), 10)
    kh_bytes = t * b * 4 + t * 5 + edges.numel() * 4 + t * 64 * 4
    out["score_sketch"] = dict(
        max_abs_err=0.0, ms=kh_ms, plain_ms=kh_plain_ms,
        bound_ms=kh_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=None,
    )
    # KG: a partly filled plane, compacted to its ladder size
    part = torch.from_numpy(rng.integers(0, b + 1, (t, 1)).astype(np.int32)).to(dev)
    n_rows = int(part.sum())
    size = 2048  # the scorer's gather ladder: powers of two from 2048
    while size < n_rows:
        size *= 2
    size = min(size, t * b)
    g_k = gather_rows(sc_k, part, size)
    g_p = gather_rows_plain(sc_k, part, size)
    torch.cuda.synchronize()
    check(torch.equal(g_k.view(torch.int32), g_p.view(torch.int32)), f"{shape} KG bitwise")
    kg_ms = cuda_time_ms(lambda: gather_rows(sc_k, part, size), 50)
    kg_plain_ms = cuda_time_ms(lambda: gather_rows_plain(sc_k, part, size), 10)
    flat_mask = (torch.arange(b, device=dev)[None, :] < part).reshape(-1)
    flat = sc_k.reshape(-1)
    lib_ms = cuda_time_ms(lambda: flat[flat_mask], 50)
    kg_bytes = n_rows * 4 + t * 4 + size * 4
    out["gather_rows"] = dict(
        max_abs_err=0.0, ms=kg_ms, plain_ms=kg_plain_ms,
        bound_ms=kg_bytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=lib_ms,
    )
    for name, rec in out.items():
        emit({"phase": "kernel", "shape": shape, "name": name, **rec})
    return out


# -- phase 3b: KF at deepar_replay ----------------------------------------------

def replay_windows() -> np.ndarray:
    """BASELINE config 3's input as bench.py:341-358 builds it: per series,
    a daily sine plus noise from RandomState(1), replayed in event-time
    order and cut into context-length windows at stride = context
    (series-major: series 0's windows first). f32[128, 128]."""
    rng = np.random.RandomState(1)
    windows = []
    for s_i in range(REPLAY_SERIES):
        vals = (
            21.0
            + 4.0 * np.sin(np.arange(REPLAY_POINTS) / 24 * 2 * np.pi + s_i)
            + rng.randn(REPLAY_POINTS) * 0.2
        )
        for lo in range(0, REPLAY_POINTS - REPLAY_CONTEXT + 1, REPLAY_CONTEXT):
            windows.append(vals[lo: lo + REPLAY_CONTEXT])
    return np.stack(windows).astype(np.float32)


def replay_phase(dev, spec, cfg, params, windows) -> dict:
    """KF against forecast_plain on the same noise: the first horizon step
    of every path and the mean over samples within the bf16 bar."""
    import torch

    from sitewhere_tpu_torch.models.deepar import forecast_plain

    b = windows.shape[0]
    paths = cfg.num_samples * b
    eps = torch.randn((cfg.horizon, paths), device=dev,
                      generator=torch.Generator(dev).manual_seed(5))
    samples, mean = spec.forecast(params, cfg, windows, eps=eps)
    ps, pm = forecast_plain(params, cfg, windows, eps)
    torch.cuda.synchronize()
    check(tuple(samples.shape) == (cfg.num_samples, b, cfg.horizon), "KF samples shape")
    check(bool(torch.isfinite(samples).all() and torch.isfinite(mean).all()), "KF finite")
    first = float((samples[..., 0] - ps[..., 0]).abs().max())
    mean_err = float((mean - pm).abs().max())
    path_err = float((samples - ps).abs().max())
    check(bool(torch.allclose(samples[..., 0], ps[..., 0], rtol=TOL, atol=TOL)),
          f"KF first step within {TOL} (max abs err {first})")
    check(bool(torch.allclose(mean, pm, rtol=TOL, atol=TOL)),
          f"KF mean within {TOL} (max abs err {mean_err})")
    check(bool(torch.allclose(mean, samples.mean(0), rtol=1e-5, atol=1e-5)), "KF mean of its samples")
    kf_ms = cuda_time_ms(lambda: spec.forecast(params, cfg, windows, eps=eps), 20)
    kf_plain_ms = cuda_time_ms(lambda: forecast_plain(params, cfg, windows, eps), 3, 1)
    h = HIDDEN
    step = 2.0 * 3 * h + 2.0 * h * 3 * h          # one GRU step of one row
    flops = b * REPLAY_CONTEXT * step + cfg.horizon * paths * (step + 2 * 2.0 * h)
    n_params = sum(v.numel() for n in params.values() for v in n.values())
    nbytes = 4 * (windows.numel() + eps.numel() + samples.numel() + mean.numel() + n_params)
    peak = BF16_FLOPS if cfg.dtype == "bfloat16" else F32_FLOPS
    rec = dict(
        max_abs_err=max(first, mean_err), first_step_err=first, mean_err=mean_err,
        path_err=path_err, ms=kf_ms, plain_ms=kf_plain_ms,
        bound_ms=max(flops / peak, nbytes / HBM_BYTES_PER_S) * 1e3,
        bound_by="operations" if flops / peak > nbytes / HBM_BYTES_PER_S else "bytes",
        library_ms=None, flops=flops,
    )
    emit({"phase": "kernel", "shape": "deepar_replay", "name": "deepar_forecast", **rec})
    return rec


# -- phase 4: the main path ---------------------------------------------------------

def _hist_oracle(edges: np.ndarray, scores: np.ndarray, counts: np.ndarray) -> np.ndarray:
    bins = np.r_[-np.inf, edges, np.inf]
    out = np.zeros((scores.shape[0], 1, len(bins) - 1), np.int64)
    for t in range(scores.shape[0]):
        out[t, 0], _ = np.histogram(scores[t, : counts[t, 0]], bins=bins)
    return out


def drive(scorer, flushes: int, rng, seq0: int, record: list) -> dict:
    """Feed Zipf-repeating tenant traffic through the flush protocol:
    registry -> lane rings -> staging -> stage -> step -> gather -> d2h,
    then flush until the lanes are empty, so every fed row is scored.
    Times the host's traffic making apart from the protocol, and the
    device time of each flush (CUDA events around step and gather; the
    step's wait on its h2d copy falls inside)."""
    import torch

    from sitewhere_tpu_torch.pipeline.inference import (
        StreamRegistry, _LaneRing, _StagingSet,
    )

    t = scorer.n_slots
    b = SHAPES["tenants32"][1]
    regs = [StreamRegistry(1, scorer.max_streams) for _ in range(t)]
    lanes = {(slot, 0): _LaneRing(2 * b) for slot in range(t)}
    sets = [_StagingSet(scorer, b), _StagingSet(scorer, b)]
    fed, resolved, pending = set(), [], []
    n_devices = scorer.max_streams * 3 // 4  # every device gets a stream
    gen_s = proto_s = 0.0
    f = 0
    while f < flushes or any(lane.count for lane in lanes.values()):
        t_gen = time.perf_counter()
        if f < flushes:
            seq = seq0 + f
            for slot in range(t):
                n = int(rng.integers(b - b // 4, b + b // 8 + 1))  # some lanes overflow
                devs = zipf_ids(rng, n_devices, n)
                uniq, inv = np.unique(devs, return_inverse=True)
                local = np.array(
                    [regs[slot].lookup_or_assign(f"dev-{d}", "temperature")[1] for d in uniq],
                    np.int32,
                )
                vals = (np.sin(devs * 0.1 + f) + 0.1 * rng.normal(size=n)).astype(np.float32)
                lanes[(slot, 0)].push(local[inv], vals, seq * 1000 + slot, np.arange(n, dtype=np.int32))
                fed.update((seq * 1000 + slot, r) for r in range(n))
        t_proto = time.perf_counter()
        gen_s += t_proto - t_gen
        st = sets[f % 2]
        st.ensure_reusable()
        st.counts[:] = 0
        take = sum(min(lane.count, b) for lane in lanes.values())
        seqs = np.empty((take,), np.int64)
        rows = np.empty((take,), np.int32)
        moved = 0
        for (slot, d), lane in sorted(lanes.items()):
            k = min(lane.count, b)
            lane.pop_into(k, st.ids[slot], st.vals[slot], d * b, seqs, rows, moved)
            st.counts[slot, d] = k
            moved += k
        st.staged = scorer.stage_inputs(st.ids, st.vals, st.counts)
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        scores = scorer.step_counts(*st.staged)
        gathered = scorer.gather_rows(scores, st.staged[2], moved)
        ev1.record()
        gathered.copy_to_host_async()
        scorer.last_sketch.copy_to_host_async()
        proto_s += time.perf_counter() - t_proto
        # the twin's copy of this flush (outside the timed protocol)
        record.append((st.ids.copy(), st.vals.copy(), st.counts.copy(), moved))
        pending.append((gathered, scorer.last_sketch, scores, seqs, rows, moved, ev0, ev1))
        f += 1
    host, device_ms, negative = [], [], 0
    for gathered, sketch, scores, seqs, rows, moved, ev0, ev1 in pending:
        t_reap = time.perf_counter()
        g = gathered.numpy_f32()
        proto_s += time.perf_counter() - t_reap
        device_ms.append(ev0.elapsed_time(ev1))
        check(bool(np.isfinite(g[:moved]).all()), "main path: finite scores")
        check(bool(np.isnan(g[moved:]).all()), "main path: NaN padding past the rows")
        negative += int((g[:moved] < 0).sum())
        resolved.extend(zip(seqs.tolist(), rows.tolist()))
        host.append((g, np.asarray(sketch), scores.numpy_f32()))
    check(len(resolved) == len(set(resolved)), "main path: no row resolved twice")
    check(set(resolved) == fed, "main path: every fed row scored")
    return {"host": host, "rows": len(fed), "flushes": f, "gen_s": gen_s,
            "protocol_s": proto_s, "device_ms": device_ms, "negative": negative}


def twin_check(kern, twin, record, host, tag: str) -> float:
    """Replay the recorded flushes into the plain twin; state bitwise,
    gathered scores within the bf16 bar. Returns the max abs error."""
    worst = 0.0
    for (ids, vals, counts, moved), (g, sketch, plane) in zip(record, host):
        tg = twin.gather_rows(twin.step_counts(ids, vals, counts), counts, moved).numpy_f32()
        check(bool(np.array_equal(np.isnan(tg), np.isnan(g))), f"{tag}: NaN layout")
        err = float(np.max(np.abs(tg[:moved] - g[:moved])))
        worst = max(worst, err)
        check(bool(np.allclose(g[:moved], tg[:moved], rtol=TOL, atol=TOL)),
              f"{tag}: scores vs plain twin (max abs err {err})")
        check(bool(np.array_equal(sketch, _hist_oracle(kern.sketch_edges, plane, counts))),
              f"{tag}: sketch equals the np.histogram oracle")
    import torch

    for name, a, c in zip(("values", "pos", "count"), kern.state, twin.state):
        check(torch.equal(a, c), f"{tag}: window state {name} bitwise")
    return worst


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; it runs on the card", file=sys.stderr)
        return 2
    try:
        from sitewhere_tpu_torch import kernels
        from sitewhere_tpu_torch.models import get_model, make_config
        from sitewhere_tpu_torch.parallel.mesh import MeshManager
        from sitewhere_tpu_torch.parallel.sharded import ShardedScorer
    except ImportError as exc:
        print(f"chip_smoke: run it from a checkout of the repository ({exc})",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = card_line()
    nvcc = subprocess.run([kernels.nvcc_path(), "--version"], capture_output=True, text=True)
    emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc.stdout.strip().splitlines()[-1],
          "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()})

    kernels.load()  # builds from csrc/ with nvcc
    emit({"phase": "build", "seconds": kernels.build_seconds,
          "ptxas": [ln.strip() for ln in kernels.build_log.splitlines()
                    if "registers" in ln or "spill" in ln]})

    dev = torch.device("cuda", 0)
    # the plain versions' matmuls accumulate in full precision, as the
    # reference's do (KS and KD accumulate their dot products in f32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    mm = MeshManager(device=dev)
    t32, b32, s32 = SHAPES["tenants32"]

    def scorers(family: str, cfg, seed: int):
        """A kernel scorer and its plain twin per wire (f32, bf16), every
        slot active with its own weights from ``seed``."""
        spec = get_model(family)
        gen = torch.Generator().manual_seed(seed)
        trees = [spec.init(gen, cfg, device=dev) for _ in range(t32)]
        out = {}
        for wire in ("f32", "bf16"):
            for plain in (False, True):
                sc = ShardedScorer(mm, spec, cfg, slots_per_shard=t32, max_streams=s32,
                                   window=WINDOW, wire_dtype=wire, plain=plain)
                for slot, tree in enumerate(trees):
                    sc.activate(slot, params=tree)
                out[(wire, plain)] = sc
        return spec, out

    lstm_cfg = make_config("lstm_ad", {"window": WINDOW, "hidden": HIDDEN})  # bf16 compute
    lstm_spec, lstm = scorers("lstm_ad", lstm_cfg, 11)
    deepar_cfg = make_config("deepar", {"context": REPLAY_CONTEXT, "hidden": HIDDEN,
                                        "num_samples": 64})  # bf16 compute, horizon 24
    deepar_spec, dar = scorers("deepar", deepar_cfg, 12)

    results = {name: kernel_phase(name, dev, lstm_spec, lstm_cfg, lstm[("f32", False)].params)
               for name in ("tenants32", "lstm_engine")}
    results["forecasting32"] = kernel_phase(
        "forecasting32", dev, deepar_spec, deepar_cfg, dar[("f32", False)].params)
    fc_params = deepar_spec.init(torch.Generator().manual_seed(13), deepar_cfg, device=dev)
    windows = torch.from_numpy(replay_windows()).to(dev)
    results["deepar_replay"] = {
        "deepar_forecast": replay_phase(dev, deepar_spec, deepar_cfg, fc_params, windows)}

    # the main paths, counts set to 0 just before each and read just after
    rng = np.random.default_rng(2024)
    launches = {name: 0 for name in kernels.KERNELS}
    twins = {}
    for family, sc, flushes, seq0 in (("lstm_ad", lstm, (8, 3), 0),
                                      ("deepar", dar, (4, 2), 1000)):
        rec32, recbf = [], []
        kernels.reset_launches()
        main = drive(sc[("f32", False)], flushes[0], rng, seq0, rec32)
        bf = drive(sc[("bf16", False)], flushes[1], rng, seq0 + 100, recbf)
        counts = kernels.launches()
        emit({"phase": "main_path", "family": family, "flushes": main["flushes"],
              "bf16_flushes": bf["flushes"], "rows": main["rows"], "bf16_rows": bf["rows"],
              "traffic_gen_s": main["gen_s"], "protocol_s": main["protocol_s"],
              "protocol_rows_per_s": main["rows"] / main["protocol_s"],
              "device_ms_per_flush": main["device_ms"],
              "device_busy_share": sum(main["device_ms"]) / 1e3 / main["protocol_s"],
              "negative_scores": main["negative"] + bf["negative"], "launches": counts})
        for name in ("window_update", SCORER[family], "score_sketch", "gather_rows"):
            check(counts[name] > 0, f"{family} main path launched {name}")
        for name, n in counts.items():
            launches[name] += n
        twins[family] = (
            twin_check(sc[("f32", False)], sc[("f32", True)], rec32, main["host"],
                       f"{family} f32 wire"),
            twin_check(sc[("bf16", False)], sc[("bf16", True)], recbf, bf["host"],
                       f"{family} bf16 wire"),
        )
    kernels.reset_launches()
    samples, mean = deepar_spec.forecast(
        fc_params, deepar_cfg, windows, torch.Generator(dev).manual_seed(2024))
    torch.cuda.synchronize()
    counts = kernels.launches()
    check(counts["deepar_forecast"] > 0, "forecast launched deepar_forecast")
    check(bool(torch.isfinite(samples).all() and torch.isfinite(mean).all()),
          "forecast: finite samples and mean")
    lo, hi = float(windows.min()), float(windows.max())
    check(lo - 10 < float(mean.min()) and float(mean.max()) < hi + 10,
          "forecast: mean within the series' range +- 10")
    emit({"phase": "main_path", "family": "deepar", "path": "forecast",
          "series": int(windows.shape[0]), "samples": int(samples.shape[0]),
          "horizon": int(samples.shape[-1]), "mean_range": [float(mean.min()), float(mean.max())],
          "launches": counts})
    for name, n in counts.items():
        launches[name] += n
    emit({"phase": "twin", **{f"{fam}_{wire}_wire_max_abs_err": err
                              for fam, errs in twins.items()
                              for wire, err in zip(("f32", "bf16"), errs)}})

    kernel_line = []
    for name, shape in (("window_update", "tenants32"), ("lstm_score", "tenants32"),
                        ("gru_score", "forecasting32"), ("deepar_forecast", "deepar_replay"),
                        ("score_sketch", "tenants32"), ("gather_rows", "tenants32")):
        r = results[shape][name]
        kernel_line.append({
            "name": name, "route": "cuda",
            "source": f"sitewhere_tpu_torch/csrc/{kernels.KERNELS[name][0]}",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"kernels": kernel_line})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
