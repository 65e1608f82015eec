#!/usr/bin/env python3
"""Hold variants of the flash-attention source against the committed kernel on one card.

    python3 scripts/flash_variants.py

A variant is ``src/repro_torch/kernels/csrc/flash_attention.cu`` with one
text replacement (``VARIANTS`` below), written and built as ``chip_smoke.py``
writes and builds its planted faults, into ``build/repro_torch/variants/``.  At the main path's long bf16 shapes each
build is checked against the plain version at ``chip_smoke.py``'s gate (the
elements outside it are counted, not asserted: a variant may be wrong on
purpose) and timed with CUDA events, in turns: committed, each variant,
committed.  It prints one JSON line per shape and build, then the card's
``nvidia-smi`` line.  Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# name: (kernel source, text of the committed source, its replacement), as chip_smoke.PLANTED
VARIANTS = {"p_hi_only": ("flash_attention", "      wgmma_rs<DV>(acc, p_lo[kb], vd);\n", "")}
CHANGES = {"p_hi_only": "P·V with P rounded to bf16 alone, without the lo part"}

# label, B, S, H, Kv, hd, window, softcap: chip_smoke.py's long serve shapes and its ragged one
SHAPES = [("gemma2-serve-long", 1, 4608, 8, 4, 256, 4096, 50.0),
          ("gemma2-serve-long", 1, 4608, 8, 4, 256, 0, 50.0),
          ("jamba-serve-long", 1, 4096, 32, 8, 128, 0, 0.0),
          ("gemma2-ragged", 1, 4600, 8, 4, 256, 4096, 50.0)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    import repro_torch.kernels.flash_attention as fa
    from repro_torch.kernels import _build

    copies = cs.planted_sources(VARIANTS, "variants")
    with ThreadPoolExecutor(max_workers=len(copies)) as pool:
        list(pool.map(lambda copy: _build.compile_source(*copy), copies.values()))
    committed = fa._lib()
    libs = {"committed": committed, **{name: fa._bind(ctypes.CDLL(str(lib))) for name, (_, lib) in copies.items()}}
    order = ["committed", *VARIANTS, "committed"]
    card = cs.smi_line()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, B, S, H, Kv, hd, window, cap in SHAPES:
        q, k, v = cs.attention_inputs(torch, gen, "bfloat16", B, S, S, H, Kv, hd)
        kw = dict(causal=True, window=window, logit_softcap=cap, q_offset=0)
        plain = fa.flash_attention_plain(q, k, v, **kw)
        tol = cs.kernel_tol("bfloat16", plain)
        rows = {}
        try:
            for name in order:
                fa._lib = lambda lib=libs[name]: lib
                out = fa.flash_attention(q, k, v, **kw)
                torch.cuda.synchronize()
                row = rows.setdefault(name, dict(outside_tol=cs.n_outside(out, plain, tol),
                                                 max_abs_err=(out.float() - plain.float()).abs().max().item(),
                                                 ms=[]))
                row["ms"].append(cs.cuda_ms(torch, lambda: fa.flash_attention(q, k, v, **kw)))
        finally:
            fa._lib = lambda: committed
        for name, row in rows.items():
            print(json.dumps(dict(shape=f"{label} bf16 B{B} S=T={S} H{H} Kv{Kv} hd{hd} window{window} cap{cap}",
                                  build=name, change=CHANGES.get(name, "none"),
                                  elements=plain.numel(), tol=tol, card=card, **row)), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
