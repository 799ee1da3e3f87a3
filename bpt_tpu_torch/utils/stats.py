"""Host-side render statistics accumulator.

Mirror of BvhStats (src/core/stats.h:8-50): the device counts in exact
int64; the host accumulates into Python ints (no overflow) and prints the
same block at render end.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class RenderStats:
    rays_traced: int = 0  # path rays (reference-parity counter)
    shadow_rays: int = 0  # BDPT connection visibility rays (ours)
    bvh_node_visits: int = 0
    aabb_hits: int = 0
    triangle_tests: int = 0
    triangle_hits: int = 0
    bvh_nodes_built: int = 0
    wall_seconds: float = 0.0

    @property
    def total_rays(self) -> int:
        return self.rays_traced + self.shadow_rays

    @property
    def mrays_per_sec(self) -> float:
        if self.wall_seconds <= 0:
            return 0.0
        return self.total_rays / self.wall_seconds / 1e6

    def summary(self) -> str:
        # print_bvh_stats (stats.h:34-50) + throughput line
        lines = [
            "[render stats]",
            f"  rays traced:     {self.rays_traced}",
            f"  shadow rays:     {self.shadow_rays}",
            f"  bvh node visits: {self.bvh_node_visits}",
            f"  aabb hits:       {self.aabb_hits}",
            f"  triangle tests:  {self.triangle_tests}",
            f"  triangle hits:   {self.triangle_hits}",
            f"  nodes built:     {self.bvh_nodes_built}",
            f"  wall:            {self.wall_seconds:.3f}s",
            f"  throughput:      {self.mrays_per_sec:.2f} Mrays/s",
        ]
        return "\n".join(lines)
