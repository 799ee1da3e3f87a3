"""Copies of this checkout's bpt_tpu_torch that each change one design
element of the brute-force hit kernels (csrc/intersect.cu), for
tools/ab_tri_kernels.py.

    python tools/tri_variants.py DEST [NAME ...]

Writes DEST/NAME/{bpt_tpu_torch, chip_smoke.py} for each NAME given (all of
them by default) and prints the directories.  Each copy differs from the
checkout by the substitutions listed for it in VARIANTS:

- nocompact: element A alone, the persistent grid without compaction: a
  warp takes 32 consecutive lanes at a time, one a thread, dead ones too
  (a dead lane's thread runs one test its empty interval cannot accept),
  and refills only when all 32 threads are free, as the grid over B did;
- anylockstep: compaction without the flat loop for the any hit (B
  alone): a warp hands out rays only when all its threads are free;
- closestflat: the flat loop on the closest hit (C there): its threads
  refill once 4 are free, each at its own triangle;
- anyrefill1, anyrefill8, anyrefill16: the any hit refills at 1, 8 or 16
  free threads, not 4;
- anysteps1, anysteps8, anysteps16: a thread of the any hit takes up to
  1, 8 or 16 steps between two of its warp's looks for free threads, not
  4;
- chunk32: a warp takes 32 lanes from the counter at once, whatever B;
- any16: the any hit held to 32 registers, 16 blocks an SM (element D);
- closest8: the closest hit's registers bounded for 8 blocks an SM;
- sweeproll: the lockstep sweep's loop not unrolled.

A NAME joined with "+" applies each part's substitutions.  Then, for
example:

    python tools/ab_tri_kernels.py build/ab/parent . build/ab/v/nocompact \\
        build/ab/v/nocompact . build/ab/parent
"""

from __future__ import annotations

import sys
from pathlib import Path

from pt_brute_variants import make

KERNEL = "bpt_tpu_torch/csrc/intersect.cu"
ANY_REFILL = "constexpr int ANY_REFILL = 4;"
CHUNK = "p.chunk = (int)std::min(1024LL, std::max(32LL, c & ~31LL));"
VARIANTS = {
    "nocompact": [
        (KERNEL, ANY_REFILL, "constexpr int ANY_REFILL = 32;"),
        (KERNEL, CHUNK, "p.chunk = 32;"),
        (KERNEL, "  if (in && !live) write_miss<F, ANY>(p, k);\n", ""),
        (KERNEL, "__ballot_sync(0xffffffffu, live);", "__ballot_sync(0xffffffffu, in);"),
        (KERNEL, "  if (live) ring[", "  if (in) ring["),
        (KERNEL, "    return ++k == T;", "    return ++k == T || !(tmin <= tmax);"),
    ],
    "anylockstep": [(KERNEL, ANY_REFILL, "constexpr int ANY_REFILL = 32;")],
    "closestflat": [(KERNEL, "constexpr int CLOSEST_REFILL = 32;",
                     "constexpr int CLOSEST_REFILL = 4;")],
    **{f"anyrefill{k}": [(KERNEL, ANY_REFILL, f"constexpr int ANY_REFILL = {k};")]
       for k in (1, 8, 16)},
    **{f"anysteps{k}": [(KERNEL, "constexpr int ANY_STEPS = 4;",
                         f"constexpr int ANY_STEPS = {k};")] for k in (1, 8, 16)},
    "chunk32": [(KERNEL, CHUNK, "p.chunk = 32;")],
    "any16": [(KERNEL, "__global__ void __launch_bounds__(TRI_BLOCK) any_tri(",
               "__global__ void __launch_bounds__(TRI_BLOCK, 16) any_tri(")],
    "closest8": [(KERNEL, "__global__ void __launch_bounds__(TRI_BLOCK) closest_tri(",
                  "__global__ void __launch_bounds__(TRI_BLOCK, 8) closest_tri(")],
    "sweeproll": [(KERNEL, "      while (!ray.step(s_tri, p.T)) {",
                   "#pragma unroll 1\n      while (!ray.step(s_tri, p.T)) {")],
}


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    for name in args[1:] or VARIANTS:
        print(make(Path(args[0]), name, VARIANTS))
    return 0


if __name__ == "__main__":
    sys.exit(main())
