"""Write ``csrc/wgmma_mma.cuh``: one wrapper per ``wgmma.mma_async`` shape the
kernels of this package use.

A ``wgmma`` instruction names every accumulator register in its text, so a
wrapper for m64nNk16 is N/2 operands long and cannot be produced by a C++
template. This script prints them: for each N in ``WIDTHS`` a specialisation
``Wgmma<N>`` with ``ss`` (A and B from shared-memory descriptors) and, for
the widths in ``RS_WIDTHS``, ``rs`` (A from registers). bf16 operands, f32
accumulators. The header is committed; run this again only to add a width:

``python3 -m apvt_lora_torch.tools.gen_wgmma > <package>/csrc/wgmma_mma.cuh``
"""

from __future__ import annotations

WIDTHS = (16, 32, 48, 64, 128, 192, 208, 256)
RS_WIDTHS = (64,)  # the widths that also take A from registers

_HEAD = """\
// Generated by tools/gen_wgmma.py; do not edit by hand.
//
// Wrappers of wgmma.mma_async.sync.aligned.m64nNk16.f32.bf16.bf16 for the
// widths N the kernels of this directory use. A warpgroup (4 warps) computes
// D (64 x N, f32, N/2 registers a thread) = A (64 x 16) B (16 x N), plus D
// when `acc` is not 0. `ss`: A and B through shared-memory matrix
// descriptors; TA / TB = 1 says the operand is MN-major (its M or N index is
// the contiguous one in shared memory), 0 K-major. `rs`: A from registers,
// the m16n8k16 A fragment of each warp's 16 rows. Element i of d lies at
// row 16 * warp + lane / 4 + 8 * ((i >> 1) & 1), column 8 * (i >> 2) +
// 2 * (lane % 4) + (i & 1). The caller brackets a run of these with
// wgmma_fence() ... wgmma_commit(); wgmma_wait<0>().

#pragma once

#include <stdint.h>

namespace apvt {

template <int N>
struct Wgmma;
"""


def _spec(n: int) -> str:
    regs = n // 2
    d_list = ", ".join(f"%{i}" for i in range(regs))
    d_ops = ", ".join(f'"+f"(d[{i}])' for i in range(regs))
    r = regs
    lines = [f"template <>\nstruct Wgmma<{n}> {{",
             "  template <int TA, int TB>",
             f"  static __device__ __forceinline__ void ss(float (&d)[{regs}], uint64_t a, "
             "uint64_t b, int acc) {",
             "    asm volatile(",
             f'        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"',
             f'        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "',
             f'        "{{{d_list}}}, "',
             f'        "%{r}, %{r + 1}, p, 1, 1, %{r + 3}, %{r + 4};\\n}}\\n"',
             f"        : {d_ops}",
             '        : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));',
             "  }",
             *_rs(n, regs, d_list, d_ops),
             "};\n"]
    return "\n".join(lines)


def _rs(n: int, r: int, d_list: str, d_ops: str) -> list[str]:
    if n not in RS_WIDTHS:
        return []
    return ["  template <int TB>",
            f"  static __device__ __forceinline__ void rs(float (&d)[{r}], "
            "const uint32_t (&a)[4], uint64_t b,",
            "                                            int acc) {",
            "    asm volatile(",
            f'        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n"',
            f'        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "',
            f'        "{{{d_list}}}, "',
            f'        "{{%{r}, %{r + 1}, %{r + 2}, %{r + 3}}}, %{r + 4}, p, 1, 1, %{r + 6};\\n}}\\n"',
            f"        : {d_ops}",
            '        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(TB));',
            "  }"]


def render() -> str:
    return _HEAD + "\n" + "\n".join(_spec(n) for n in WIDTHS) + "\n}  // namespace apvt\n"


if __name__ == "__main__":
    print(render(), end="")
