"""Time KA's bf16 split kernels (``csrc/attention_split.cu``,
``attention_split_bwd.cu``), or with ``--form staged`` its bf16 staged
kernels (``csrc/attention.cu``, ``attention_bwd.cu``), in variants of their
sources, on one card, in one process: each variant's two sources are built
with ``common.cu`` into a library of its own, then every variant runs the
forward and the backward at the form's shapes (split: main path p's 65,536
x 31 x 512, causal, and 64 x 197 x 512; staged: transformer32's 65,536 x 31
x 4 x 32, causal, ViT-B/16-224's 64 x 197 x 12 x 64 and the transformer
forecast's 128 x 128 x 4 x 32, causal), twice, in turns (the order reversed
the second time), each output held bitwise against the first variant's
where both trees compute the same bits. Prints one JSON line a shape
({variant: [[fwd ms, bwd ms, bitwise], ...]}) and the card's name and power
limit.

    python sitewhere_tpu_torch/split_probe.py [--form split|staged] \\
        [--tree NAME=PATH ...] [--sub 'NAME|FILE|OLD|NEW' ...]

The variant ``this`` is the tree's sources as they are. ``--tree`` adds
another tree's (for example a ``git archive`` of the parent), ``--sub``
this tree's with the text OLD of FILE (one of the form's two sources or a
header) replaced by NEW (several ``--sub`` of one NAME apply together). It needs
nvcc and a card; nothing runs at import.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# form -> (its two sources, their kernels' names, the shapes it is timed at)
FORMS = {
    "split": (("attention_split.cu", "attention_split_bwd.cu"),
              ("attention_split", "attention_split_bwd"),
              {"p_hd512_t31": (65536, 31, 1, 512, True), "hd512_t197": (64, 197, 1, 512, False)}),
    "staged": (("attention.cu", "attention_bwd.cu"), ("attention", "attention_bwd"),
               {"transformer32": (65536, 31, 4, 32, True), "vit_b16": (64, 197, 12, 64, False),
                "forecast_t128": (128, 128, 4, 32, True)}),
}


def _variant_sources(csrc: Path, sources, subs, out: Path) -> Path:
    """The ``sources`` of ``csrc`` and the headers they include, with
    ``subs`` [(file, old, new)] applied (to a source or a header), into
    ``out``."""
    out.mkdir(parents=True, exist_ok=True)
    names = [src.name for src in csrc.glob("*.cuh")] + list(sources)
    for file, _old, _new in subs:
        if file not in names:
            raise ValueError(f"{file}: not a source or header of this form")
    for name in names:
        text = (csrc / name).read_text()
        for file, old, new in subs:
            if file == name:
                if old not in text:
                    raise ValueError(f"{name}: {old!r} not found")
                text = text.replace(old, new)
        (out / name).write_text(text)
    return out


def _build(nvcc: str, flags, common_obj: Path, src_dir: Path, sources, lib: Path) -> str:
    log = []
    objs = [common_obj]
    for name in sources:
        obj = src_dir / f"{name}.o"
        r = subprocess.run([nvcc, *flags, "-c", str(src_dir / name), "-o", str(obj)],
                           capture_output=True, text=True)
        log.append(r.stdout + r.stderr)
        if r.returncode:
            raise RuntimeError(f"nvcc failed for {src_dir / name}:\n{log[-1][-4000:]}")
        objs.append(obj)
    subprocess.run([nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", *map(str, objs),
                    "-o", str(lib)], check=True)
    return "\n".join(log)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--form", choices=sorted(FORMS), default="split")
    ap.add_argument("--tree", action="append", default=[], help="NAME=PATH of another tree")
    ap.add_argument("--sub", action="append", default=[], help="NAME|FILE|OLD|NEW")
    args = ap.parse_args(argv)
    sources, names, shapes = FORMS[args.form]

    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # this tree's package
    from sitewhere_tpu_torch import kernels
    from sitewhere_tpu_torch.models import common as tc

    if not torch.cuda.is_available():
        print("split_probe: no CUDA device", file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parent / "csrc"
    variants = {"this": (here, [])}
    for spec in args.tree:
        name, path = spec.split("=", 1)
        variants[name] = (Path(path) / "sitewhere_tpu_torch" / "csrc", [])
    for spec in args.sub:
        name, file, old, new = spec.split("|")
        variants.setdefault(name, (here, []))[1].append((file, old, new))
    nvcc = kernels.nvcc_path()
    work = Path(tempfile.mkdtemp(prefix="split_probe_"))
    common = work / "common.o"
    subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-c", str(here / "common.cu"), "-o", str(common)],
                   check=True, capture_output=True)

    def build(item):
        name, (csrc, subs) = item
        src = _variant_sources(csrc, sources, subs, work / name)
        log = _build(nvcc, kernels.NVCC_FLAGS, common, src, sources, work / f"{name}.so")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        return name, work / f"{name}.so", regs

    with ThreadPoolExecutor(len(variants)) as ex:
        built = list(ex.map(build, variants.items()))
    libs = {}
    for name, path, regs in built:
        print(json.dumps({"variant": name, "ptxas": regs}), flush=True)
        lib = ctypes.CDLL(str(path))
        for k in names:
            _s, entry, argt = kernels.KERNELS[k]
            getattr(lib, entry).argtypes = argt
            getattr(lib, entry).restype = ctypes.c_int
        lib.sw_error_string.argtypes = [ctypes.c_int]
        lib.sw_error_string.restype = ctypes.c_char_p
        libs[name] = lib

    def time_ms(fn, iters):
        fn()
        fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    fwd, bwd = ((tc.attention_split, tc.attention_split_bwd) if args.form == "split"
                else (tc.attention, tc.attention_bwd))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    for tag, (n, t, h, hd, causal) in shapes.items():
        q, k, v, do = (torch.randn((n, t, h * hd), generator=gen, device=dev).to(torch.bfloat16)
                       for _ in range(4))
        first, res = None, {}
        for rnd in range(2):
            for name in (list(libs) if rnd == 0 else list(libs)[::-1]):
                kernels._lib = libs[name]
                outs = (fwd(q, k, v, h, causal), *bwd(q, k, v, do, h, causal))
                first = first or outs
                same = all(torch.equal(a, b) for a, b in zip(outs, first))
                del outs
                it = 5 if n > 1024 else 20
                res.setdefault(name, []).append([
                    time_ms(lambda: fwd(q, k, v, h, causal), it),
                    time_ms(lambda: bwd(q, k, v, do, h, causal), it), same])
        print(json.dumps({tag: res}), flush=True)
        del q, k, v, do, first
        torch.cuda.empty_cache()
    kernels._lib = None
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
