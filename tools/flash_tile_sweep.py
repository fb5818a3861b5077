#!/usr/bin/env python3
"""Time the bf16 flash kernel at several q tiles, or another flash source,
on one CUDA card.

    python3 tools/flash_tile_sweep.py [--warps 1 2 4] [--source FILE.cu]

``csrc/flash_attention.cu`` fixes its bf16 q tile in one constant,
``constexpr int MW = 4;`` (MW warps of 16 q rows each, in each of the
block's two warp groups). For each ``--warps`` count this writes a copy of
the source with that constant changed into ``build/kernels/tile_sweep/``
and builds it alone; without ``--warps`` it builds the source as written.
``--source`` takes another flash source with the same C interface (an
earlier version, say, to compare within one run). Each build is checked
against the plain version at the serve shapes (bf16 causal, B=1,
Hq=Hkv=16, D=128) and timed at S = 17, 128, 200, 384 and 512 the way
``chip_smoke.py`` times its kernels (CUDA events around a replayed CUDA
graph). Prints the card's name and power limit, then one JSON line per
build, and writes them to ``flash_tile_sweep.json`` in ``chip_smoke.py``'s
output directory.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEQ_LENS = (17, 128, 200, 384, 512)
MW_LINE = re.compile(r"constexpr int MW = (\d+);")


def build(source: Path, warps, out_dir: Path) -> ctypes.CDLL:
    """The flash library of ``source``, its q tile set to ``warps`` warps
    (None: as written)."""
    from repro_torch.kernels import _build
    text = source.read_text()
    if warps is not None:
        text, n = MW_LINE.subn(f"constexpr int MW = {warps};", text)
        if n != 1:
            raise ValueError(f"{source}: no single `constexpr int MW = ...;` to set")
    tag = f"{source.stem}_w{warps if warps is not None else 'src'}"
    src = out_dir / f"{tag}.cu"
    src.write_text(text)
    lib = out_dir / f"lib{tag}.so"
    cmd = [_build.nvcc_path(), *_build.ARCH, *_build.FLAGS, f"-I{_build.CSRC}",
           "-shared", str(src), "-o", str(lib)]
    run = subprocess.run(cmd, capture_output=True, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"nvcc failed for {tag}:\n{run.stdout}{run.stderr}")
    dll = ctypes.CDLL(str(lib))
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll.flash_attention_fwd.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32,
                                        i32, i32, f32, i32, i32, vp]
    dll.flash_attention_fwd.restype = i32
    return dll


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--warps", type=int, nargs="+", default=None)
    ap.add_argument("--source", type=Path, default=None,
                    help="flash source to build (default: the repository's)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("flash_tile_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from chip_smoke import FLASH_TOL, OUT, time_ms, within
    from repro_torch.kernels import _build, ref
    source = (args.source or _build.CSRC / "flash_attention.cu").resolve()
    warps_list = args.warps or [None]

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    out_dir = ROOT / "build" / "kernels" / "tile_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(warps_list)) as pool:
        libs = list(pool.map(lambda w: build(source, w, out_dir), warps_list))

    gen = torch.Generator(device="cuda").manual_seed(0)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    inputs = {S: [torch.randn(1, S, 16, 128, generator=gen, device="cuda").bfloat16()
                  for _ in "qkv"] for S in SEQ_LENS}
    rows = []
    for warps, lib in zip(warps_list, libs):
        if warps is None:
            found = MW_LINE.search(source.read_text())
            q_rows = 16 * int(found.group(1)) if found else None
        else:
            q_rows = 16 * warps
        row = {"source": str(source.relative_to(ROOT)) if source.is_relative_to(ROOT) else str(source),
               "warps": warps, "q_rows": q_rows, "ms": {}, "blocks": {}, "max_abs_err": 0.0}
        for S, (q, k, v) in inputs.items():
            out = torch.empty_like(q)

            def call():
                err = lib.flash_attention_fwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, S, S,
                    16, 16, 128, 128 ** -0.5, 1, 1, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")

            call()
            ok, err = within(out, ref.flash_attention_ref(q, k, v, causal=True),
                             FLASH_TOL["bfloat16"])
            if not ok:
                print(f"flash_tile_sweep: FAIL: warps={warps} S={S} max|err|={err:.3e}",
                      file=sys.stderr)
                return 1
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row["ms"][S] = time_ms(call)
            if q_rows:
                row["blocks"][S] = f"{-(-S // q_rows) * 16} blocks on {n_sm} SMs"
        rows.append(row)
        print(json.dumps(row), flush=True)
    OUT.mkdir(exist_ok=True)
    (OUT / "flash_tile_sweep.json").write_text(
        json.dumps({"card": card, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
