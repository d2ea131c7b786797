"""Build and bind the hand-written CUDA kernels of ``csrc/``.

The kernels (the scoring flush's KW ``window_update`` and, past one
block's shared memory, ``window_update_multi``, KS ``lstm_score``
for LSTM-AD, KD ``gru_score`` for DeepAR, the transformer's KE
``tf_embed``, KL ``layernorm``, KA ``attention``, KU ``bias_gelu`` and KN
``tf_head``, KH ``score_sketch`` and KG ``gather_rows``; with bf16/int8
serving weights KE and KN read them as stored and KQ ``dequant`` feeds the
projections; KA past its staged form's head dims and lengths runs tiled,
``attention_tiled`` and ``attention_tiled_bwd``; DeepAR's forecast
KF ``deepar_forecast``, the transformer's forecast on KE..KN; the ViT
classifier's KP ``frame_patches``, KJ ``dct_patches``, KV ``vit_embed``
and KT ``vit_head``, its blocks on KL, KA, KU; the recurrent families'
train step on KB ``lstm_train``, KR ``gru_train`` and KO ``adam_update``;
KS, KD and KF at any hidden, window and sample count their templated forms
do not take: ``lstm_score_wide``, ``gru_score_wide``,
``deepar_forecast_wide``; KB and KR likewise: ``lstm_train_wide``,
``gru_train_wide``; all five past the widths whose block state fits
shared memory, with that state in global memory: ``lstm_score_global``,
``gru_score_global``, ``deepar_forecast_global``, ``lstm_train_global``,
``gru_train_global`` (the wide sources' global instantiations); KE over
raw histories past 4,096 values
``tf_embed_raw``; KA at head dims past 256 ``attention_split`` and
``attention_split_bwd``; ring attention's step over ranks
``attention_ring`` (KA's block attention carrying the softmax statistics);
the transformer's train step on KE (its train mode) and
``tf_embed_bwd``, KL ``layernorm``/``layernorm_bwd``, KA
``attention``/``attention_bwd``, KU ``bias_gelu``/``bias_gelu_bwd``, KN's
train mode ``tf_head_train`` and KO; the ViT's train step on KP, KV and
``vit_embed_bwd``, the blocks' kernels, KT's train mode ``vit_head_train``
and KO) are CUDA C++ for ``sm_90a`` with a plain C interface. At first use each
source compiles with its own ``nvcc`` process, all started together, and
one more ``nvcc`` call links the objects into a single shared library
under ``sitewhere_tpu_torch/_build/``. The library's name carries a hash
of the sources and flags, so a changed source rebuilds. It is loaded with
``ctypes``: every pointer and the stream pass as ``c_void_p`` (KO's host
leaf table too).

Every C entry launches on the stream it is given (the wrappers pass
``torch.cuda.current_stream()``), allocates nothing, and returns
``cudaGetLastError()``; ``launch`` raises when that is not 0. ``launch`` is
also where each kernel's launch count goes up by one, and nowhere else.

Nothing here runs at import: the tests import every module on hosts with
no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the shared memory one block may take on the H100 (227 KB, opted in above
# 48 KB); the kernels' routes compute their caps from it
SMEM_MAX_BYTES = 232448

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# the scan kernels' (KS, KD) arguments after their weights
_SCAN_TAIL = [_P, _P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]

# kernel name -> (source, C entry, argtypes). The count of launches is
# keyed by the same names.
KERNELS: Dict[str, tuple] = {
    "window_update": (
        "window_update.cu", "sw_window_update",
        # ring, pos, count, S, W, ids, id_kind, vals, val_kind, counts,
        # mask, later, T, B, stream
        [_P, _P, _P, _I, _I, _P, _I, _P, _I, _P, _P, _P, _I, _I, _P],
    ),
    "window_update_multi": (
        "window_update_multi.cu", "sw_window_update_multi",
        # ring, pos, count, S, W, ids, id_kind, vals, val_kind, counts,
        # mask, later, T, B, chunk, keys_a, keys_b, stream
        [_P, _P, _P, _I, _I, _P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    ),
    "lstm_score": (
        "lstm_score.cu", "sw_lstm_score",
        # wx_w, wx_b, wh_w, wh_b, hd_w, hd_b, wx_s, wh_s, hd_s, wf, then the
        # scan tail: ring, pos, count, S, ids, id_kind, windows, n_valid,
        # later, active, counts, mask, out, out_kind, T, B, W, H, K, bf16,
        # stream
        [_P] * 9 + [_I] + _SCAN_TAIL,
    ),
    "gru_score": (
        "gru_score.cu", "sw_gru_score",
        # wx_w, wx_b, wh_w, wh_b, mu_w, mu_b, sg_w, sg_b, wx_s, wh_s, mu_s,
        # sg_s, wf, then the scan tail as lstm_score
        [_P] * 12 + [_I] + _SCAN_TAIL,
    ),
    "deepar_forecast": (
        "deepar_forecast.cu", "sw_deepar_forecast",
        # wx_w, wx_b, wh_w, wh_b, mu_w, mu_b, sg_w, sg_b, windows, eps,
        # samples, mean, B, C, NS, HZ, H, bf16, stream
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
         _I, _I, _P],
    ),
    "score_sketch": (
        "score_sketch.cu", "sw_score_sketch",
        # scores, kind, active, counts, mask, edges, n_edges, out, T, B,
        # stream
        [_P, _I, _P, _P, _P, _P, _I, _P, _I, _I, _P],
    ),
    "gather_rows": (
        "gather_rows.cu", "sw_gather_rows",
        # scores, kind, counts, L, B, out, size, stream
        [_P, _I, _P, _I, _I, _P, _L, _P],
    ),
    "tf_embed": (
        "tf_embed.cu", "sw_tf_embed",
        # embed_w, embed_scale, wf, embed_b, pos, P, ring, ring_pos,
        # ring_count, S, ids, id_kind, windows, n_valid, src, L, x, targets,
        # nv_out, ctx_out, mu_out, sigma_out, mode, T, B, W, D, K, tokens,
        # rows, kind, stream
        [_P, _P, _I, _P, _P, _I, _P, _P, _P, _I, _P, _I, _P, _P, _P, _I, _P,
         _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    ),
    "layernorm": (
        "layernorm.cu", "sw_layernorm",
        # x, scale, bias, out, N, D, rows_per_slot, kind, stream
        [_P, _P, _P, _P, _L, _I, _L, _I, _P],
    ),
    "attention": (
        "attention.cu", "sw_attention",
        # q, k, v, out, N, T, heads, hd, causal, kind, stream
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    ),
    "bias_gelu": (
        "bias_gelu.cu", "sw_bias_gelu",
        # x, b, out, N, F, rows_per_slot, kind, stream
        [_P, _P, _P, _L, _I, _L, _I, _P],
    ),
    "tf_head": (
        "tf_head.cu", "sw_tf_head",
        # lnf_scale, lnf_bias, head_w, head_scale, wf, head_b, h, targets,
        # n_valid, later, active, counts, mask, out, out_kind, eps, mu_n,
        # sigma_n, samples, means, ctx, ctx_next, step, HZ, T, B, Tt, D, K,
        # kind, stream
        [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P,
         _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    ),
    "frame_patches": (
        "frame_patches.cu", "sw_frame_patches",
        # frames, out, B, H, W, C, P, in_kind, out_kind, stream
        [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    ),
    "dct_patches": (
        "dct_patches.cu", "sw_dct_patches",
        # y, cb, cr, out, rgb, B, W, H, y_gw, y_gh, c_gw, c_gh, sub, k, P,
        # bf16, stream
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    ),
    "vit_embed": (
        "vit_embed.cu", "sw_vit_embed",
        # prod, bias, cls, pos, out, B, N, D, kind, stream
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    ),
    "vit_head": (
        "vit_head.cu", "sw_vit_head",
        # x, lnf_s, lnf_b, head_w, head_wf, head_b, logits, probs, ids,
        # scratch, B, T, D, C, K, kind, stream
        [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    ),
}

# the wide forms of KS, KD and KF (any hidden, window and sample count):
# the templated entries' arguments with R, rows (paths) a block, before
# the stream
_SCAN_TAIL_WIDE = _SCAN_TAIL[:-1] + [_I, _P]
KERNELS.update({
    "lstm_score_wide": ("lstm_score_wide.cu", "sw_lstm_score_wide",
                        [_P] * 9 + [_I] + _SCAN_TAIL_WIDE),
    "gru_score_wide": ("gru_score_wide.cu", "sw_gru_score_wide",
                       [_P] * 12 + [_I] + _SCAN_TAIL_WIDE),
    "deepar_forecast_wide": (
        "deepar_forecast_wide.cu", "sw_deepar_forecast_wide",
        # as deepar_forecast, then R before the stream
        [_P] * 12 + [_I] * 7 + [_P],
    ),
})

# the global forms of KS, KD and KF (the wide kernels with the block state
# in global memory): the wide entries' arguments with the scratch and the
# blocks a launch wave holds, before the stream
_SCAN_TAIL_GLOBAL = _SCAN_TAIL_WIDE[:-1] + [_P, _L, _P]
KERNELS.update({
    "lstm_score_global": ("lstm_score_wide.cu", "sw_lstm_score_global",
                          [_P] * 9 + [_I] + _SCAN_TAIL_GLOBAL),
    "gru_score_global": ("gru_score_wide.cu", "sw_gru_score_global",
                         [_P] * 12 + [_I] + _SCAN_TAIL_GLOBAL),
    "deepar_forecast_global": (
        "deepar_forecast_wide.cu", "sw_deepar_forecast_global",
        # as deepar_forecast_wide, then state and wave before the stream
        [_P] * 12 + [_I] * 7 + [_P, _L, _P],
    ),
})

# the train forms' C entry: mode, the family's weights, then ring, pos,
# count, S, windows, T, B, W, H, bf16, per_row, act, cst, hst, dhead, g_row,
# dgates, partials, reduced, stream (models/train.py)
_TRAIN_TAIL = [_P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P]
KERNELS.update({
    "lstm_train": ("lstm_train.cu", "sw_lstm_train", [_I] + [_P] * 6 + _TRAIN_TAIL),
    "gru_train": ("gru_train.cu", "sw_gru_train", [_I] + [_P] * 8 + _TRAIN_TAIL),
    # the wide train forms (any hidden and window): the templated entries'
    # arguments with R, rows a block, and wt, the slots' wh^T scratch f32[T,
    # G, H] the backward fills, before the stream
    "lstm_train_wide": ("lstm_train_wide.cu", "sw_lstm_train_wide",
                        [_I] + [_P] * 6 + _TRAIN_TAIL[:-1] + [_I, _P, _P]),
    "gru_train_wide": ("gru_train_wide.cu", "sw_gru_train_wide",
                       [_I] + [_P] * 8 + _TRAIN_TAIL[:-1] + [_I, _P, _P]),
    # their global forms: the wide entries' arguments with the mode's
    # block-state scratch and the blocks a launch wave holds, before the
    # stream
    "lstm_train_global": ("lstm_train_wide.cu", "sw_lstm_train_global",
                          [_I] + [_P] * 6 + _TRAIN_TAIL[:-1] + [_I, _P, _P, _L, _P]),
    "gru_train_global": ("gru_train_wide.cu", "sw_gru_train_global",
                         [_I] + [_P] * 8 + _TRAIN_TAIL[:-1] + [_I, _P, _P, _L, _P]),
    "adam_update": (
        "adam_update.cu", "sw_adam_update",
        # table (host), n_leaves, T, lr, bc1, bc2, mask, count, count_inc,
        # stream
        [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    ),
})

# the transformer family's train form (models/transformer.py, the block
# composition of models/common.py): the backward kernels of KA, KL, KU, KE
# and KN's train mode
KERNELS.update({
    "attention_bwd": (
        "attention_bwd.cu", "sw_attention_bwd",
        # q, k, v, dout, dq, dk, dv, N, T, heads, hd, causal, kind, stream
        [_P] * 7 + [_I] * 6 + [_P],
    ),
    "layernorm_bwd": (
        "layernorm_bwd.cu", "sw_layernorm_bwd",
        # x, scale, dy, dx, part, reduced, T, D, rows_per_slot, kind, stream
        [_P] * 6 + [_I, _I, _L, _I, _P],
    ),
    "bias_gelu_bwd": (
        "bias_gelu_bwd.cu", "sw_bias_gelu_bwd",
        # x, b, dy, dx, part, db, T, F, rows_per_slot, kind, stream
        [_P] * 6 + [_I, _I, _L, _I, _P],
    ),
    "tf_embed_bwd": (
        "tf_embed_bwd.cu", "sw_tf_embed_bwd",
        # dx, normed, part, red, dw, db, dpos, T, B, Tt, D, W, P, kind, stream
        [_P] * 7 + [_I] * 7 + [_P],
    ),
    "tf_head_train": (
        "tf_head.cu", "sw_tf_head_train",
        # mode, lnf_s, lnf_b, head_w, head_b, h, normed, out, per_row, g_row,
        # dfeats, part, red, T, B, Tt, D, W, kind, stream
        [_I] + [_P] * 12 + [_I] * 6 + [_P],
    ),
})

# the ViT's train form (models/vit.py): KT's train mode (loss and backward
# down to the final residual stream) and KV's backward
KERNELS.update({
    "vit_head_train": (
        "vit_head.cu", "sw_vit_head_train",
        # mode, x, lnf_s, lnf_b, head_w, head_b, labels, logits, lp, loss, g,
        # dh, feats, dlog, part, red, dhw, dhb, B, T, D, C, kind, stream
        [_I] + [_P] * 17 + [_I] * 5 + [_P],
    ),
    "vit_embed_bwd": (
        "vit_embed_bwd.cu", "sw_vit_embed_bwd",
        # dx, red, dpos, dcls, db, B, N, D, kind, stream
        [_P] * 5 + [_I] * 4 + [_P],
    ),
})

# the transformer's bf16/int8 serving weights and KA at any head dim and
# length: KQ (kernel_weight's dequant) and KA's tiled forward and backward
KERNELS.update({
    "dequant": (
        "dequant.cu", "sw_dequant",
        # qw, scale, out, S, I, O, kind, stream
        [_P, _P, _P, _I, _I, _I, _I, _P],
    ),
    "attention_tiled": (
        "attention_tiled.cu", "sw_attention_tiled",
        # q, k, v, out, N, T, heads, hd, causal, kind, stream
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    ),
    "attention_tiled_bwd": (
        "attention_tiled_bwd.cu", "sw_attention_tiled_bwd",
        # q, k, v, dout, dq, dk, dv, stats, N, T, heads, hd, causal, kind,
        # stream
        [_P] * 8 + [_I] * 6 + [_P],
    ),
})

# the attention families past their earlier caps: KE's raw form at any
# history length, KA's split form (and its backward) at head dims past 256
KERNELS.update({
    "tf_embed_raw": (
        "tf_embed_raw.cu", "sw_tf_embed_raw",
        # embed_w, embed_scale, wf, embed_b, pos, P, src, L, x, ctx_out,
        # mu_out, sigma_out, B, D, C, kind, stream
        [_P, _P, _I, _P, _P, _I, _P, _L, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    ),
    "attention_split": (
        "attention_split.cu", "sw_attention_split",
        # q, k, v, out, N, T, heads, hd, causal, kind, stream
        [_P] * 4 + [_I] * 6 + [_P],
    ),
    "attention_split_bwd": (
        "attention_split_bwd.cu", "sw_attention_split_bwd",
        # q, k, v, dout, dq, dk, dv, stats, N, T, heads, hd, causal, kind,
        # stream
        [_P] * 8 + [_I] * 6 + [_P],
    ),
})

# the multi-device paths (K14): KA's ring step, the block attention of ring
# attention with the running softmax statistics carried in and out
KERNELS.update({
    "attention_ring": (
        "attention_ring.cu", "sw_attention_ring",
        # q, k, v, m, l, acc, out, B, Tq, Tk, H, hd, q_off, k_off, causal,
        # stream
        [_P] * 7 + [_I] * 5 + [_L, _L, _I, _P],
    ),
})

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
# launches by variant, "name[variant]" (the recurrent kernels' width and
# weight format, e.g. "lstm_score[h16,int8]"): a launch adds one here too
VARIANT_LAUNCHES: Dict[str, int] = {}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log: str = ""          # nvcc's output (-Xptxas -v) of the last build
build_seconds: float = 0.0   # wall time of the last build (0: none ran)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    VARIANT_LAUNCHES.clear()


def launches() -> Dict[str, int]:
    return dict(LAUNCHES)


def variant_launches() -> Dict[str, int]:
    return dict(VARIANT_LAUNCHES)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels "
            "build on a host with the CUDA toolkit"
        )
    return str(path)


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (one ``nvcc`` each, in parallel) and link one
    shared library; a library whose hash matches is reused. Returns its
    path."""
    global build_log, build_seconds
    lib_path = BUILD_DIR / f"libsw_kernels_{_digest()}.so"
    if lib_path.exists():
        return lib_path
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tag = f"{os.getpid()}_{threading.get_ident()}"
    procs = []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}_{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    logs, failed = [], []
    for src, _obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name} (rc {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    objs = [obj for _s, obj, _p in procs]
    try:
        if failed:
            build_log = "\n".join(logs)
            raise RuntimeError(
                f"nvcc failed for {failed}:\n{build_log[-8000:]}"
            )
        tmp = BUILD_DIR / f"tmp_{tag}.so"
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             *map(str, objs), "-o", str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        logs.append(f"== link (rc {link.returncode})\n{link.stdout}")
        build_log = "\n".join(logs)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout[-8000:]}")
        os.replace(tmp, lib_path)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    return lib_path


def load() -> ctypes.CDLL:
    """Build if needed, load once, and declare every entry's types."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for _name, (_src, entry, argtypes) in KERNELS.items():
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.sw_error_string.argtypes = [ctypes.c_int]
            lib.sw_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(name: str, *args, variant: Optional[str] = None) -> None:
    """Call kernel ``name``'s C entry; raise on a CUDA error, count the
    launch when it went through (and under ``name[variant]`` when given)."""
    lib = load()
    rc = getattr(lib, KERNELS[name][1])(*args)
    if rc != 0:
        msg = lib.sw_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg}")
    LAUNCHES[name] += 1
    if variant is not None:
        key = f"{name}[{variant}]"
        VARIANT_LAUNCHES[key] = VARIANT_LAUNCHES.get(key, 0) + 1


def ptr(tensor) -> Optional[int]:
    """Device pointer of a tensor, None (a NULL) for None."""
    return None if tensor is None else tensor.data_ptr()


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
