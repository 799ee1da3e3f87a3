"""bpt_tpu's clustered front-to-back closest hit against its BVH walk on
the coffee stand-in, on a CPU.

Runs ``cluster_wave.clustered_closest_ftb_pallas`` (interpret mode, the
closest hit of bpt_tpu's paged pt_wave and of its large-scene jnp
dispatch) and ``ops.soa.bvh_closest`` on the same rays: random rays
inside the scene's bounds, then rays leaving the BVH's hit points of those
in new random directions (as a path's bounces do).  Prints how often the
two disagree on hit / miss and how often the clustered hit lies farther
than the BVH's, with a few such rays.

    python tools/coffee_ftb_vs_bvh.py [--rays 4096] [--seed 0]
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rays", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from bpt_tpu.core import vec3 as jv3
    from bpt_tpu.ops import soa
    from bpt_tpu.ops.pallas import cluster_wave
    from bpt_tpu.ops.pallas.clusters import pack_clusters_pages
    from bpt_tpu.scene.loader import load_scene_from_yaml

    with contextlib.redirect_stdout(sys.stderr):
        scene = load_scene_from_yaml(os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "..", "scenes", "coffee",
            "coffee_standin.yaml")).scene
    pages = pack_clusters_pages(scene)
    g = np.random.default_rng(args.seed)
    lo, hi = np.asarray(scene.bvh_min[0]), np.asarray(scene.bvh_max[0])
    o = g.uniform(lo, hi, (args.rays, 3)).astype(np.float32)
    d = g.normal(size=(args.rays, 3)).astype(np.float32)
    for name in ("random rays in the bounds", "rays leaving their hit points"):
        ov, dv = jv3.from_array(jnp.asarray(o)), jv3.from_array(jnp.asarray(d))
        ref = soa.bvh_closest(scene, ov, dv, 1e-3, jnp.inf)
        t = tri = None
        for (_c, aabb, blocks, order) in pages:  # min-t merge, as soa.py:494-504
            tp, trip, _, _ = cluster_wave.clustered_closest_ftb_pallas(
                aabb, order, blocks, ov.x, ov.y, ov.z, dv.x, dv.y, dv.z,
                jnp.ones((o.shape[0],), jnp.float32), interpret=True)
            tp, trip = np.asarray(tp), np.asarray(trip)
            take = np.ones_like(tp, bool) if t is None else tp < t
            t = tp if t is None else np.where(take, tp, t)
            tri = trip if tri is None else np.where(take, trip, tri)
        rt, rtri, rh = np.asarray(ref.t), np.asarray(ref.tri), np.asarray(ref.hit)
        h = np.isfinite(t)
        both = h & rh
        farther = both & (t > rt * (1 + 1e-5))
        print(f"{name}: {o.shape[0]} rays; hit/miss differ on {int((h != rh).sum())}; "
              f"clustered hit farther than the BVH's on {int(farther.sum())}, nearer on "
              f"{int((both & (t < rt * (1 - 1e-5))).sum())}")
        for k in np.nonzero(farther)[0][:4]:
            print(f"  ray {k}: o {o[k].tolist()} d {d[k].tolist()}: clustered t {t[k]} "
                  f"tri {tri[k]}, BVH t {rt[k]} tri {rtri[k]}")
        keep = np.isfinite(rt)
        o = (o + rt[:, None] * d)[keep].astype(np.float32)
        d = g.normal(size=o.shape).astype(np.float32)


if __name__ == "__main__":
    main()
