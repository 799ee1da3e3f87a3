"""Copies of this checkout's bpt_tpu_torch that each change one design
element of the brute-force PT megakernel, for tools/ab_walk_megakernels.py.

    python tools/pt_brute_variants.py DEST [NAME ...]

Writes DEST/NAME/{bpt_tpu_torch, chip_smoke.py} for each NAME given (all of
them by default) and prints the directories.  Each copy differs from the
checkout by the substitutions listed for it in VARIANTS:

- refill1, refill8: a warp refills when 1 or 8 of its lanes are free, not 4;
- cap4, cap5, cap6: the persistent grid held to that many blocks an SM
  (the occupancy query's per-SM count, element D); blocks8:
  ``__launch_bounds__`` at 8 blocks an SM, not 5;
- torchadds: the rows of a pixels-mode launch added into the totals by
  one torch add a stratum, not by strata_sum.

A NAME joined with "+" applies each part's substitutions (cap5+refill1).

Then, for example:

    python tools/ab_walk_megakernels.py --brute build/ab/parent . build/ab/v/refill1 \\
        build/ab/v/refill1 . build/ab/parent
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNEL = "bpt_tpu_torch/csrc/pt_megakernel.cu"
WRAPPER = "bpt_tpu_torch/ops/kernels/pt_kernel.py"
BRUTE_BLOCKS = "return bpt::resident_blocks(bpt::pt_megakernel, bpt::BLOCK, cache, 64);"
VARIANTS = {
    "refill1": [(KERNEL, "constexpr int PT_REFILL = 4;", "constexpr int PT_REFILL = 1;")],
    "refill8": [(KERNEL, "constexpr int PT_REFILL = 4;", "constexpr int PT_REFILL = 8;")],
    "blocks8": [(KERNEL, "constexpr int BRUTE_BLOCKS = 5;", "constexpr int BRUTE_BLOCKS = 8;")],
    **{f"cap{k}": [(KERNEL, BRUTE_BLOCKS, BRUTE_BLOCKS.replace("64);", f"64, {k});"))]
       for k in (4, 5, 6)},
    "torchadds": [(WRAPPER, "strata_sum(rows, tot, first=k0 == 0)",
                   "strata_sum_plain(rows, tot, first=k0 == 0)")],
}


def make(dest: Path, name: str, variants=None) -> Path:
    """Writes DEST/NAME, a copy of the checkout with NAME's substitutions
    from ``variants`` (this tool's VARIANTS by default)."""
    variants = VARIANTS if variants is None else variants
    out = dest / name
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    shutil.copytree(ROOT / "bpt_tpu_torch", out / "bpt_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copy2(ROOT / "chip_smoke.py", out / "chip_smoke.py")
    for rel, old, new in (sub for part in name.split("+") for sub in variants[part]):
        path = out / rel
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} is not in {rel} exactly once")
        path.write_text(text.replace(old, new))
    return out


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    for name in args[1:] or VARIANTS:
        print(make(Path(args[0]), name))
    return 0


if __name__ == "__main__":
    sys.exit(main())
