"""What limits the bf16 dwconv7 kernel on the card: time it beside edited
copies of itself, the first (staged) design and ``F.conv2d(groups=C)``.

Builds ``csrc/dwconv7.cu`` and edited copies of it:

* ``1-row blocks``: every block one output row (the odd-height rule
  everywhere);
* ``1-row blocks, 12 warps``: the same with three warps a scheduler instead
  of two (whether latency, and not issue, is the limit);
* ``stores from registers``: each lane stores its channel pairs with
  ``st.global`` instead of the staging buffer and the TMA store;
* ``3-row blocks, stores from registers`` and ``4-row blocks, stores from
  registers``: larger blocks (more reuse of each loaded input row, more
  registers and code);
* ``no products``: the 49-tap sums replaced by one read per output (the
  loads, stores and schedule alone; wrong values);
* ``no loads after the first``: the ring's refills replaced by an arrival
  (the slots keep their first tiles: the TMA traffic taken out; wrong values);
* ``products only``: no loads after the first and no stores (the results
  kept alive by a test that never holds; wrong values).

The exact copies (the kernel and the next five) are held bit for bit against the staged
kernel at the four ConvNeXt-B stage shapes (B=64), forward. Then, per stage,
every build, the staged kernel and the library call take turns (CUDA-graph
replay of 20 forward calls, best of 3: device time), one line per stage with
each time's share of the f32 FMA bound. Last, host microseconds per call
(2000 eager calls at a 1 x 7 x 7 x 64 map) of the wrapper, the staged
wrapper, the ctypes launch alone and ``F.conv2d``.

Run on a machine with a CUDA card, from the repository root:
``python3 -m apvt_lora_torch.tools.dwconv_diagnose``.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import time

STAGES = ((64, 56, 56, 128), (64, 28, 28, 256), (64, 14, 14, 512), (64, 7, 7, 1024))
PEAK_F32 = 67e12

_ROWS = "constexpr int kMaxRows = 2;"
_WARPS = "constexpr int kWarps = 8;         // two a scheduler"
_ASSERT = 'static_assert(kMaxTileH % kMaxRows == 0, "tile rows in whole blocks");'
_PARAM = "const __grid_constant__ CUtensorMap omap,\n"
_ARGS = "(map, omap, static_cast<const bf16*>(taps), s)"
_STORE_START = "      // out through a staging buffer and one TMA store"
_STORE_END = "      sbuf ^= 1;\n"
_CONV = "      conv_rows<ROWS>(rows - r0, acc, in0, row_words, tk);"
_STAGING = "constexpr int kStagingBytes = 2 * kWarps * kStageBytes;"
_REFILL = "        load_item(ring, full, &map, s, first + j + s.slots, slot);"

_DIRECT_STORE = """      const int R = min(ROWS, rows - r0);
      if (c < s.C) {
        bf16* o = out + (((size_t)it.b * s.H + it.h0 + r0) * s.W + it.w0 + s0) * s.C + c;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (r >= R) break;
#pragma unroll
          for (int q = 0; q < kCols; ++q)
            if (s0 + q < cols) store2(o + ((size_t)r * s.W + q) * s.C, acc[r][q]);
        }
      }
"""
_SINK = """      float sink = 0.f;
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int q = 0; q < kCols; ++q) sink += acc[r][q].x + acc[r][q].y;
      if (sink == 1234.5f) reinterpret_cast<uint32_t*>(staging)[lane] = 0u;
"""


def _replace(text: str, old: str, new: str, label: str) -> str:
    if old not in text:
        raise RuntimeError(f"dwconv7.cu changed: the edit for {label!r} found nothing to replace")
    return text.replace(old, new)


def _stores(text: str, block: str, label: str) -> str:
    """The TMA store block replaced by ``block``, with an ``out`` pointer passed in."""
    i = text.find(_STORE_START)
    j = text.find(_STORE_END, i)
    if i < 0 or j < 0:
        raise RuntimeError(f"dwconv7.cu changed: the edit for {label!r} found nothing to replace")
    text = text[:i] + block + text[j + len(_STORE_END):]
    text = _replace(text, _PARAM, _PARAM + "            bf16* __restrict__ out,\n", label)
    return _replace(text, _ARGS, "(map, omap, static_cast<bf16*>(out), "
                    "static_cast<const bf16*>(taps), s)", label)


def variants(text: str) -> dict[str, str]:
    """``{label: source}`` from the text of ``csrc/dwconv7.cu`` with its
    headers inlined; raises if an edit no longer finds its place."""
    rows = lambda t, n, label: _replace(t, _ROWS, f"constexpr int kMaxRows = {n};", label)
    direct = _replace(_stores(text, _DIRECT_STORE, "stores from registers"), _STAGING,
                      "constexpr int kStagingBytes = 0;", "stores from registers")
    no_loads = _replace(text, _REFILL, "        mbar_arrive(&full[slot]);", "no loads")
    out = {"kernel": text,
           "1-row blocks": rows(text, 1, "1-row blocks"),
           "1-row blocks, 12 warps": _replace(rows(text, 1, "12 warps"), _WARPS,
                                              "constexpr int kWarps = 12;        // three a "
                                              "scheduler", "12 warps"),
           "stores from registers": direct}
    for n in (3, 4):
        label = f"{n}-row blocks, stores from registers"
        out[label] = _replace(rows(direct, n, label), _ASSERT, "", label)
    out["no products"] = _replace(
        text, _CONV, "      for (int r = 0; r < ROWS; ++r) for (int q = 0; q < kCols; ++q) "
        "acc[r][q] = make_float2(__uint_as_float(in0[r * row_words + q * 32]), 0.f);",
        "no products")
    out["no loads after the first"] = no_loads
    out["products only"] = _stores(no_loads, _SINK, "products only")
    return out


EXACT = ("kernel", "1-row blocks", "1-row blocks, 12 warps", "stores from registers",
         "3-row blocks, stores from registers", "4-row blocks, stores from registers")


def main() -> None:
    import torch
    import torch.nn.functional as F

    from ..kernels import _build
    from ..kernels import dwconv as kd
    from .timing import graph_ms

    if not torch.cuda.is_available():
        raise SystemExit("dwconv_diagnose: this needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    sources = variants(_build.inlined("dwconv7.cu"))
    names = {label: f"dwconv7_diagnose_{i}.cu" for i, label in enumerate(sources)}
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(lambda kv: _build.load_text(names[kv[0]], kv[1]),
                                          sources.items())))
    p, i = ctypes.c_void_p, ctypes.c_int
    for label, lib in libs.items():
        lib.apvt_dwconv7.argtypes = [p, p, p, i, i, i, i, i, i, p]
        lib.apvt_dwconv7.restype = i
        found = re.findall(r"Compiling entry function '\w*dwconv7_tmaILi(\d)E\w*'(?:.*\n)+?"
                           r".*?(\d+) bytes spill stores.*\n.*Used (\d+) registers",
                           _build.BUILD_LOG.get(names[label], ""))
        print(f"dwconv_diagnose build {label}: " + ", ".join(
            f"{rows}-row kernel {regs} registers, spill stores {spill} B"
            for rows, spill, regs in found), flush=True)

    def launch(lib, x, taps):
        out = torch.empty_like(x)
        rc = lib.apvt_dwconv7(x.data_ptr(), taps.data_ptr(), out.data_ptr(), *x.shape, 1, 0,
                              torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"dwconv_diagnose: launch failed ({rc})")
        return out

    gen = torch.Generator("cuda").manual_seed(0)
    for stage, shape in enumerate(STAGES, 1):
        x = torch.randn(*shape, device="cuda", generator=gen).to(torch.bfloat16)
        w = (torch.randn(7, 7, shape[-1], device="cuda", generator=gen) * 0.15).to(torch.bfloat16)
        want = kd.staged_fwd(x, w)
        same = [label for label in EXACT if torch.equal(launch(libs[label], x, w), want)]
        if len(same) != len(EXACT):
            raise RuntimeError(f"dwconv_diagnose {shape}: {set(EXACT) - set(same)} differ from "
                               f"the staged kernel")
        c = shape[-1]
        wf, x_cl = w.permute(2, 0, 1).reshape(c, 1, 7, 7), x.permute(0, 3, 1, 2)
        fns = {"staged": lambda: kd.staged_fwd(x, w),
               **{label: (lambda lib=lib: launch(lib, x, w)) for label, lib in libs.items()},
               "F.conv2d": lambda: F.conv2d(x_cl, wf, None, 1, 3, 1, c)}
        best = {}
        for _ in range(3):
            for label, fn in fns.items():
                best[label] = min(best.get(label, float("inf")), graph_ms(fn))
        bound = 2 * 49 * x.numel() / PEAK_F32 * 1e3
        print(f"dwconv_diagnose stage {stage} {shape} fwd, device ms (share of the f32 FMA "
              f"bound {bound:.4f} ms), the exact builds equal to the staged kernel: "
              + "; ".join(f"{k} {v:.4f} ({bound / v:.0%})" for k, v in best.items())
              + f" [{card}]", flush=True)

    x = torch.randn(1, 7, 7, 64, device="cuda", generator=gen).to(torch.bfloat16)
    w = torch.randn(7, 7, 64, device="cuda", generator=gen).to(torch.bfloat16)
    out = torch.empty_like(x)
    lib, stream = kd._lib(), torch.cuda.current_stream().cuda_stream
    wf, x_cl = w.permute(2, 0, 1).reshape(64, 1, 7, 7), x.permute(0, 3, 1, 2)
    calls = {"the wrapper (fused_dwconv7_fwd)": lambda: kd.fused_dwconv7_fwd(x, w),
             "the staged wrapper": lambda: kd.staged_fwd(x, w),
             "the ctypes launch alone": lambda: lib.apvt_dwconv7(
                 x.data_ptr(), w.data_ptr(), out.data_ptr(), 1, 7, 7, 64, 1, 0, stream),
             "F.conv2d(groups=C)": lambda: F.conv2d(x_cl, wf, None, 1, 3, 1, 64)}
    for turn in (1, 2):
        cells = []
        for label, fn in calls.items():
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2000):
                fn()
            cells.append(f"{label} {(time.perf_counter() - t0) / 2000 * 1e6:.2f}")
            torch.cuda.synchronize()
        print(f"dwconv_diagnose host us per call, turn {turn}: " + "; ".join(cells)
              + f" [{card}]", flush=True)


if __name__ == "__main__":
    main()
