#!/usr/bin/env python3
"""Smoke test of bpt_tpu_torch on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and builds the CUDA
   kernel from bpt_tpu_torch/csrc/ (printing the build seconds and ptxas's
   register report).
2. Holds each kernel against its plain PyTorch version on the card, on the
   same inputs.  PT: pt_megakernel with injected uniforms and in RNG mode
   at B = 65,536 rays, depth 10; pt_megakernel_pixels at 64x64 and at the
   main path's chunk shape, 512x512 (2^18 pixels), both 16 spp, depth 10;
   tolerance rtol 1e-4 / atol 1e-6.  BDPT, for bdpt and bdpt-mis:
   bdpt_megakernel with injected uniforms and in RNG mode at B = 65,536,
   depth 10 on the cornell box and B = 16,384 on the mixed-material
   scene; bdpt_megakernel_pixels at the main path's shape (512x512, 16
   spp, depth 10), and bdpt-mis at 64x64, 4 spp, depth 80 on the mixed
   scene; tolerance rtol 1e-4 / atol 1e-5.  Each comparison needs >= 99.9%
   of lanes within tolerance (a path may take another branch on a one-ulp
   difference; the worst lane is printed), and the pixels mode's counters
   must be exact.  Times kernel and plain version at B = 65,536 and at
   512x512, and the kernel at depth 80.
3. Drives the main path: render() of the cornell box with PT at 512x512,
   16 spp, depth 10, seed 0 — one warm-up and three timed renders.  The
   kernel's launch count must be > 0 and the plain version's 0, and
   rays_traced within 0.01% of 11,506,161: the count of bpt_tpu's own
   fused kernel (pt_megakernel_pixels in interpret mode on a CPU, the
   same configuration, seed and threefry stream, summed over 4096-pixel
   chunks; tools/pt_reference_rays.py).  The TPU runs of
   BENCH_r02..r04.json counted 11,497,620 (-0.074%); git history shows
   the fused PT path on this scene unchanged since the round-4 run, so
   that gap lies between TPU and CPU arithmetic, not in the code.  That
   count is printed, not checked.  Writes output/chip_smoke_cornell_pt.png.
   strata_sum (the in-order add of a launch's per-sample radiance into the
   pixel totals) must launch once a megakernel launch, and on the
   warm-up's own rows equal its plain version to the bit; timed beside
   its plain version and torch.sum.
   Then the same for BDPT and BDPT-MIS (the CLI's default integrator and
   its MIS variant): each kernel launched, the plain version never, the
   image deterministic, finite and not black; rays_traced and shadow_rays
   are printed beside the TPU bench's counts (BENCH_r04.json) and those of
   bpt_tpu's fused kernel on a CPU, not checked.  Writes output/chip_smoke_cornell_bdpt{,-mis}.png.

4. The coffee stand-in (91,540 triangles), built from the five OBJ files
   and three light meshes of scenes/coffee/coffee_standin.yaml through
   SceneBuilder calls; where PyYAML is installed, also loaded through the
   port's loader and held equal.  Prints the parse, BVH and upload seconds.
5. closest_bvh against its plain version (ops.soa.bvh_closest) at B =
   65,536, on the coffee camera's primary rays and on as many random rays
   inside the scene's bounds: hit, triangle and t exact on >= 99.9% of
   lanes, the four counters exact.  Times kernel and plain version.
6. any_bvh against its plain version (ops.soa.bvh_any) at B = 65,536
   coffee shadow rays: 32,768 real connection rays of a coffee BDPT-MIS
   wave (every 12th lane of its ten shadow waves: origin at a camera
   vertex, tmax just short of a light vertex, a pair that fails the
   connection tests dead with tmax <= 0) and 32,768 random rays in the
   scene's bounds with random tmax, one lane in eight dead.  Every lane's
   answer and the four counters exact; kernel and plain version timed.
7. pt_wave against pt_wave_plain at B = 65,536 coffee rays, depth 4, in
   both modes (each bounce closest_bvh's walk, then the wave kernel's
   shade; paged=True: pt_wave calls closest_bvh and hands the hits to
   pt_wave_bounce), rtol 1e-4 / atol 1e-6 on >= 99.9% of lanes,
   rays_traced and the four walk counters exact.
8. The coffee PT main path: render() with PT at 512x512, 16 spp, depth 10,
   seed 0 (bench.py's coffee cell) — one warm-up and three timed renders.
   The wave kernel's launches must be > 0, closest_bvh's equal to them
   (its walk before each shade), any_bvh's and every plain version's calls
   0, the image finite, not black and bitwise identical across renders.
   rays_traced is printed beside the TPU bench's 11,110,273
   (BENCH_r03/r04.json), not checked against it: bpt_tpu's own Pallas
   pt_wave counts 2.58% fewer rays than its BVH path on a pixel subset
   (tools/coffee_reference_rays.py; PERF.md, Findings).  Checked instead:
   the port's count on that subset (every 257th pixel, all 16 strata)
   within 0.1% of bpt_tpu's BVH path on a CPU (44,024), and the whole
   image within 1% of the TPU count scaled by bpt_tpu's own BVH / Pallas
   ratio on the subset.  Writes output/chip_smoke_coffee_pt.png.  Last,
   one wave-kernel launch against its plain version at the main path's
   first bounce (B = 4,194,304): all 13 state rows (origin, direction and
   throughput on the lanes that stay alive) within rtol 1e-4 / atol 1e-6
   on >= 99.9% of lanes, all five counters exact; both timed (the walk
   and the shade together, and the shade alone on the walk's hits).  Then
   each of the 10 bounces of the warm-up render, on its own inputs, timed,
   and their sum.
9. The large-scene BDPT wave route against its plain traversals: the coffee
   stand-in's bdpt-mis render loop at 16x16, 4 spp, depth 2, once through
   closest_bvh / any_bvh and once through ops.soa.bvh_closest / bvh_any
   on the card (plain=True): >= 99.9% of pixels within rtol 1e-4 / atol
   1e-5 (bitwise equality is expected and printed), all six counters
   exact, no kernel launched by the plain run and no plain walk by the
   kernel run.
10. The BDPT main path: render() of the coffee stand-in with bdpt-mis at
   512x512, 4 spp, depth 10, seed 0 (bench.py's coffee BDPT cell), then
   with bdpt at the same shape — each one warm-up and three timed renders.
   closest_bvh must launch 19 times and any_bvh 10 times a wave (depth 10
   camera and 9 light bounces; one shadow wave per camera vertex), no
   other kernel and no plain version; the image finite, not black and
   bitwise identical across renders.  Prints the walls, Mrays/s,
   rays_traced and shadow_rays (beside the TPU bench's bdpt-mis counts,
   4,294,700 and 695,189 in BENCH_r04.json, as a gap: bpt_tpu's clustered
   closest hit misses nearer hits), waves per render and peak device
   memory.  Checked instead: the port's counts on every 257th pixel (all 4
   strata) within 0.1% (rays) and 1% (shadow rays) of bpt_tpu's CPU route
   for the same stream (tools/coffee_reference_rays_bdpt.py); bdpt's
   shadow rays within 1% of the port's plain route on a CPU, since
   bpt_tpu's count there is 2.9% above it by connections between two
   points of the floor plane, which carry no radiance.  The inputs
   of one closest_bvh and one any_bvh launch of the warm-up render (camera
   bounce 1; the shadow wave of camera vertex 1) are held against the
   plain versions and timed at the main path's own shapes, and each of the
   warm-up render's 19 closest_bvh and 10 any_bvh launches timed on its
   own inputs, with their sums.  Writes
   output/chip_smoke_coffee_bdpt{-mis,}.png.

11. closest_tri / any_tri (the brute-force hits of a scene without a
   BVH) against their plain versions (ops.soa.brute_closest / brute_any)
   on 65,613 random rays with per-lane [tmin, tmax] (one lane in five
   dead, one in seven to inf) in the cornell box and in a 256-triangle
   soup, in float32 and float64: triangle and any-answer exact, t, u, v
   within 1e-6.
12. The ref_vis BDPT main path: render() of the cornell box with bdpt and
   ref_vis at 256x256, 64 spp, depth 10, seed 0 (the reference binary's
   own configuration, tests/test_ref_rmse.py) — one warm-up and three
   timed renders through the stratum loop: closest_tri must launch 19 and
   any_tri 10 times a wave, nothing else launch and no plain version run;
   the images bitwise equal, their 8x8-downsampled RMSE against the
   binary's PNG under bpt_tpu's bound 0.045; peak device memory printed.
   On every 257th pixel x 64 strata the card's rays within 0.1% of
   bpt_tpu's CPU route (tools/cornell_reference_rays_refvis.py) and its
   shadow rays within 1% of the port's plain route on this machine's CPU
   (bpt_tpu's, decided by XLA's contracted arithmetic at the endpoint
   ties, printed with the gap).  Each of the warm-up's 19 closest_tri and
   10 any_tri launches timed on its own inputs as the render makes them
   (tri_launch_times), with its live lanes and bound, and their sums.
   Both kernels held against their plain versions at the main path's
   shapes (tri_slice_vs_plain): the whole launch's answers on every 4th
   lane of camera bounce 1 and on every 40th lane of the shadow wave of
   camera vertex 1 (1,048,576 lanes across its ten light rows) equal to
   the bit to that slice's own launch, then the slice against both plain
   versions (compare_tri); both timed at the full shapes, the live lanes
   of each light row printed; the route at 64x64, 16 spp bitwise equal to
   its plain=True twin, counters included.  Writes
   output/chip_smoke_cornell_ref_vis.png.
13. Defocus on the card: the cornell box at 512x512, 16 spp, depth 10,
   defocus angle 1 focused at the room's centre, with pt and with bdpt —
   one warm-up and three timed renders each through the stratum loop,
   launching pt_megakernel / bdpt_megakernel in rays mode only, no plain
   version; walls and Mrays/s printed.  Each warm-up's one pt_megakernel /
   bdpt_megakernel launch (B = 4,194,304) timed on its own inputs, bounded
   and held against its plain version there (defocus_wave_vs_plain): its
   radiance on every 16th lane equal to the bit to that slice's own
   launch, and the slice within rtol 1e-4 / atol 1e-6 (PT) or 1e-5 (BDPT)
   of the plain version on >= 99.9% of lanes, every counter exact.
14. The CLI's --f64 (64x64, 4 spp; its BDPT default) in this process:
   exit 0, the float64 closest_tri / any_tri launched, no plain version.
15. The megakernels' walk mode (scenes over 512 triangles, the clustered
   mode of bpt_tpu's kernels) against the plain versions on the card:
   PT, bdpt and bdpt-mis in rays mode (injected uniforms and the kernel's
   stream) and pixels mode (256x256, 1 spp) on the 964-triangle scene of
   tests/torch_parity.py at B = 65,536, depth 10, each kernel timed there;
   then on the coffee stand-in, whose torch walks take 10-15 s a bounce:
   the plain PT version at 8x8 pixels and depth 2, and at the real shapes (65,536 and 16,384 rays, 128x128 pixels, a
   64x64 bdpt-mis case at depth 80) the plain estimators over the BVH
   kernels closest_bvh / any_bvh, which equal the torch walks on every
   lane (phases 5, 6, 10).  rtol 1e-4 / atol 1e-6 (PT)
   and 1e-5 (BDPT) on >= 99.9% of lanes; rays, shadow rays and the four
   walk counters exact.  Then the coffee subsets through the fused kernels
   against bpt_tpu's counts for their stream on a CPU: PT on every 257th
   pixel x 16 strata of 512x512, depth 10 (44,024, the count pt_wave's
   identical stream gives: tools/coffee_reference_rays.py); bdpt and
   bdpt-mis on every 257th pixel x 4 strata (tools/
   coffee_reference_rays_fused.py), rays within 0.1%, shadow rays within
   1% (bdpt's against the port's plain kernel on a CPU: ROADMAP §3).
16. The slice's main path: render() of the coffee stand-in with bdpt-mis
   at 512x512, 4 spp, depth 80 — one warm-up and three timed renders,
   each one bdpt_megakernel_pixels launch in walk mode (one 2^18-pixel
   chunk), no other kernel, no plain version; images bitwise equal; wall,
   Mrays/s, shadow rays and peak memory printed beside the BDPT wave
   loop's 37.145 s (PERF.md).  The kernel timed at that shape, and held
   against its plain version on the main path's own inputs (4 spp, depth
   80): every 16th pixel of the chunk with the plain estimator's walks
   over closest_bvh / any_bvh, and 4 of its pixels walking in torch; rtol
   1e-4 / atol 1e-5 on >= 99.9% of lanes, every counter exact.  Prints
   the kernel's ms and peak device memory, its persistent grid (the walk
   kernels' resident blocks, csrc/walk_sched.cuh), its vertex scratch
   bytes and the sha256 of the render's framebuffer.
17. Coffee bdpt at 256x256, 1 spp, depth 10 (under 2^18 samples: fused),
   its wall beside the stratum loop's forced on the same config (the jnp
   stream over closest_bvh / any_bvh); the two images differ by stream
   only, so their mean radiances agree within 5 sigma.
18. Coffee PT at 256x256, 16 spp, depth 10: three renders through
   render()'s route, pt_wave (bpt_tpu takes its fused kernel under 2^18
   pixels; on the H100 pt_wave is faster: ROADMAP §3), against three
   through the fused loop forced, one pixels-mode launch each:
   rays_traced equal, >= 99.9% of pixels within rtol 1e-4 / atol 1e-6
   (the max difference printed); both walls, and both routes' walls at
   32x32 / 1 spp, 64x64 / 4 spp and 128x128 / 16 spp.  Then coffee
   bdpt-mis at 512x512 / 4 spp / depth 10 through the fused loop, forced,
   three times, its median beside phase 10's BDPT wave route.
19. Defocus on the coffee stand-in, bdpt and pt at 128x128, 4 spp, depth
   10: the stratum loop, one rays-mode launch in walk mode a wave, no
   other kernel and no plain version; each wave's launch timed.
20. The clustered hit kernels (Pallas kernels 10-13: clustered_closest /
   clustered_any, plucker_closest / plucker_any) against their plain
   versions on 65,536 coffee primary rays over (T_MIN, inf) and on as
   many random rays in the scene's bounds with per-lane [tmin, tmax], one
   lane in eight dead: hit, triangle and any-answer exact and t, u, v
   within 1e-6 on >= 99.9% of lanes, the four counters exact; kernel and
   plain version timed on the primaries.
21. The coffee bdpt-mis main path (512x512, 4 spp, depth 10, seed 0)
   with BPT_TPU_NO_FTB=1, then with BPT_TPU_WAVE_IMPL=plucker, bpt_tpu's
   switches for those kernels: one warm-up and three timed renders each.
   clustered_closest (plucker_closest) must launch 19 times and
   clustered_any (plucker_any) 10 times a wave, no other kernel and no
   plain version; the images bitwise identical across renders, finite and
   not black.  bpt_tpu's cluster boxes are the triangles' unpadded bounds,
   so its clustered kernels never enter a cluster flat in one axis and
   count more rays than its BVH route (ROADMAP §3).  Checked instead of
   the default route's count: the card's counts on every 257th pixel (all
   4 strata) within 0.1% (rays) and 1% (shadow rays) of bpt_tpu's route
   with the same switch on a CPU, its Pallas kernels in interpret mode
   (tools/coffee_reference_rays_clustered.py), and the whole image within
   1% of phase 10's count scaled by the ratio of the two routes on that
   subset.  Prints the walls, Mrays/s, shadow rays, the pixels that
   differ from the default route's image and peak device memory; times
   each kernel at the main path's own shapes (camera bounce 1, B =
   1,048,576; the shadow wave of camera vertex 1, B = 10,485,760).
   21b. The warp-wide clustered hits (clustered_closest, plucker_closest,
   clustered_any, plucker_any; cluster_edge_phase) against their plain
   versions, t, tri, u, v or the any answer to the bit and the counters
   exact, on cluster_edge_lanes' cases: the coffee stand-in at B = 1, 31
   and 37; 2,048 lanes all dead, one live a warp, origins on a chop or
   rolled cluster box's plane with that direction component zero, tmin
   below T_MIN, tmax = inf; rays at a duplicated sphere whose twin
   triangles tie at equal t (the ties counted); a lane whose Plücker t
   overflows to +inf with tmax = inf (no hit).  Each kernel's whole launch
   of the tmin-below-T_MIN case equals its launches on every 3rd and every
   7th lane.
22.The refilling wave kernels' edge cases on the 964-triangle scene of
   tests/torch_parity.py (refill_cases): B = 1, 31 and 37, four times
   closest_bvh's persistent grid and 5 lanes more, every lane inactive,
   one live lane in ten scattered among 65,536.  closest_bvh equal to its
   plain version to the bit (t, tri, u, v, counters); pt_wave_bounce in
   both modes with its counters equal, dead lanes' rows copied to the bit,
   live lanes equal to the bit to the same lanes launched alone, packed,
   and within rtol 1e-4 / atol 1e-6 of the plain version.  The brute-force
   PT kernel on its persistent grid (brute_pt_cases): rays mode at B = 1,
   31, 37, four times its persistent grid and 5 lanes more, every lane
   inactive, one live lane in ten scattered, live lanes equal to the bit
   to their packed launch; pixels mode at depth 1 and at depth 80 (the
   mixed scene), with spp_loop 1 and over 4 stratum ranges; rays mode
   with injected uniforms: rtol 1e-4 / atol 1e-6 on >= 99.9% of lanes,
   all five counters exact.  The brute-force
   BDPT kernel on its persistent grid (brute_bdpt_cases), bdpt and
   bdpt-mis: rays mode on cornell camera rays at B = 1, 31, 37, four times
   its persistent grid and 5 lanes more, every lane inactive, one live
   lane in ten scattered; pixels mode at depth 1 and at depth 80 (the
   mixed scene, 1 spp); rays mode with injected uniforms; pixels mode over 4
   stratum ranges: within rtol 1e-4 / atol 1e-5 of the plain version on
   >= 99.9% of lanes, all six counters exact, live lanes equal to the bit
   to their packed launch.  any_bvh on its refilling grid (any_cases) on
   the 964-triangle scene: B = 1, 31, 37, 65,536 dead lanes, one live lane
   among 1,048,576, 65,536 live lanes: answers and counters equal to the
   plain version's.
23. Textures (texture_phases).  (a) texture_value on 1,048,576 card lanes
   against the same call on the CPU, with an image atlas made from a
   seeded array (so no phase passes or fails on a file's pixels): image,
   checker and solid lookups exact, noise within 1e-5; prints whether
   Pillow imports.  (b) pt_wave's textured mode (the shade with every
   textured albedo 1, the torch texel stage after each bounce) against
   pt_wave_plain at B = 65,536, depth 3, on the coffee stand-in with
   bench.py's checker (closest_bvh's hits) and on a 40-triangle textured
   scene without a BVH (closest_tri's hits; a checker light at y = 6.03):
   phase 7's rule, rtol 1e-4 / atol 1e-6 on >= 99.9% of lanes, rays and
   walk counters exact, each kernel launched once a bounce and no plain
   version.  (c) The textured coffee PT render (bench.py's
   coffee_91k_tex_pt: 512x512, 4 spp, depth 10, seed 0): one warm-up and
   three timed renders through pt_wave, closest_bvh and pt_wave_bounce
   launched 10 times a render each, nothing else and no plain version, the
   image finite, not black and bitwise identical across renders;
   rays_traced beside the same render untextured (textures change
   throughput only); each bounce of the warm-up timed on its own inputs
   (walk + shade, the shade alone, the texel stage) and the first bounce's
   launch with its texel stage held against the plain version on every
   16th lane, every state row (the origin rows on every lane: a lane that
   ends at a hit leaves its hit point).  (d) scenes/earth.yaml through
   render(): PT at its own 512x512, 64 spp, depth 8 (pt_wave), then
   BDPT-MIS at 256x256, 4 spp, depth 8 (the BDPT wave loop): the launches,
   no plain version, finite, not black and bitwise repeatable images, the
   walls and Mrays/s; prints the image atlas's shape ("magenta fallback"
   where the image did not load).  Writes output/chip_smoke_coffee_tex_pt.png
   and output/chip_smoke_earth_{pt,bdpt-mis}.png.
24. Volumes (volume_phases).  (a) scenes/cornell_smoke.yaml (12 triangles,
   two constant-density boxes over 24 boundary triangles) loads and every
   megakernel takes it.  (b) The volume mode of each kernel against its
   plain version: pt_megakernel in rays mode with injected draws and on
   the stream (B = 65,536, depth 10) and pt_megakernel_pixels (64x64 x 4
   spp, depth 16) on cornell_smoke; bdpt_megakernel, bdpt and bdpt-mis,
   rays mode both ways on every 16th lane of B = 65,536 and pixels mode at
   64x64 x 4 spp; the walk mode of both (rays mode both ways at B = 4,096,
   depth 4, pixels mode at 32x32 x 4 spp) and pt_wave, untextured and
   with a checker-textured volume (B = 8,192, depth 6), on the 964-triangle
   scene with a volume box: rtol 1e-4 / atol 1e-6 (PT, the wave) or 1e-5
   (BDPT) on >= 99.9% of lanes, every counter exact.  (c) The slice's main
   path, cornell_smoke at its own 256x256, 64 spp, depth 16 through
   render() with pt, bdpt and bdpt-mis: one warm-up and three timed
   renders each, one pixels-mode launch of the volume kernel and one
   strata_sum a render, nothing else, images bitwise repeatable; each
   launch timed at that shape; the CLI on the scene in a subprocess, exit
   0.  (d) The large volume scene through render(): PT (pt_wave), bdpt
   (the fused loop's walk mode) and PT with defocus (the stratum loop,
   rays mode), each route's rays on every 257th pixel against its plain
   route.  Writes output/chip_smoke_cornell_smoke_{pt,bdpt,bdpt-mis}.png
   and output/chip_smoke_volume_*.png.
25. Multi-device rendering and render_resilient (distributed_phases).
   (a) render_distributed on [cuda:0] x 4 and x 3 for the cornell box
   with pt, bdpt and bdpt-mis at 512x512, 16 spp, depth 10 (the fused
   loop), and on x 2 for coffee PT (512x512, 16 spp: pt_wave) and coffee
   bdpt-mis (4 spp: the BDPT wave loop), depth 10: each image and all six
   counters equal to phases 3, 8 and 10's render() to the bit, the route's
   kernels launched and no plain version; walls of three renders after a
   warm-up.  (b) render_spp_sharded over [cuda:0] x 4 (stratum s0 + d a
   device, four batches) for cornell pt, pt with defocus and bdpt at the
   same shape: within rtol 1e-5 / atol 1e-6 of the single-device stratum
   loop, rays equal, pt_megakernel in pixels and rays mode and
   bdpt_megakernel in rays mode launched once a stratum; a pixel-sharded
   ref_vis bdpt render (64x64, 16 spp, depth 10) over x 2 equal to
   render()'s through closest_tri / any_tri.  (c) Two processes on the
   one card, launch_local(2, device="cuda", backend="gloo"), cornell bdpt
   and coffee PT at 512x512, 16 spp, depth 10: the gathered image equal
   to render()'s, each rank's printed launches > 0 and no plain call.  (d)
   render_resilient with an injected failure: cornell bdpt in four fused
   chunks failing at chunk 2, coffee PT in four pt_wave batches failing at
   the second: each image equal to render()'s.  The kernels line gains
   each kernel's launches under phase 25 (distributed_launches).
26. Float64 on scenes with a BVH (f64_phases): the stratum loop over the
   float64 walk kernels bvh64<false> / bvh64<true> (closest_bvh / any_bvh
   on a float64 scene), whose registers, spill bytes and persistent grids
   it prints from the build's log.  (b) The main path:
   render() of the coffee stand-in in float64, bdpt-mis and pt at 512x512,
   4 spp, depth 10, one warm-up and three timed renders each: the float64
   walk kernels launched and nothing else, no plain version, images
   finite, not black and bitwise repeatable, rays_traced within 0.1% of
   the float32 stratum loop on the same jnp stream; walls, Mrays/s and
   peak memory printed, the BDPT render's beside its wave shape and
   BDPT_WAVE_BYTES.  (a) The float64 kernels against their plain walks
   on 65,536 random coffee rays with per-lane intervals and inactive lanes,
   on every 16th lane of the bdpt-mis render's camera bounce 1 and on
   every 160th lane of its shadow wave of camera vertex 1: hit, tri and
   the four counters exact, t, u, v within 1e-12 relative, the lanes that
   differ in any bit printed; both kernels timed at the render's camera
   bounce 1 and that shadow wave, with their bounds (FP64 operations over
   34 TFLOP/s).  (c) The CLI's --f64 on scenes/glass/glass_standin.yaml
   at 160x90, 4 spp, depth 80, PT, on the coffee stand-in at 64x64, 4 spp
   (its BDPT default and PT) and on scenes/earth.yaml at 64x64, 4 spp:
   exit 0 through the float64 walks, no plain call.  (d) render_distributed of the float64 coffee
   PT render over [cuda:0] x 2, equal to render()'s to the bit.  The
   kernels line lists closest_bvh_f64 and any_bvh_f64 as entries of their
   own, their launches those of (b).
27. The north-star's shapes (northstar_phase; tools/torch_northstar.py
   renders it at 1024 spp).  (a) The glass stand-in (510 triangles) at
   1920x1080, 1 spp, depth 80 with pt, bdpt and bdpt-mis through render():
   route "fused", 8 pixels-mode launches each (the last chunk 238,592
   pixels), nothing else and no plain version, images finite and not
   black, rays > 0; walls printed.  (b) The image's last 32 pixels at
   strata [1020, 1024) of 1024 spp, depth 80 (sample ids up to
   2,123,366,399), each pixels-mode kernel launched on that stratum range
   alone and held against its plain version over the same samples, rtol
   1e-4 / atol 1e-6 (PT) or 1e-5 (BDPT) on >= 99.9% of lanes, counters
   exact.  The pt_megakernel and bdpt_megakernel entries of the kernels
   line gain the launches of (a) and the error of (b).

Each phase prints its seconds, and the script its total.  The second-to-last line is a JSON object
describing the kernels, each with its bound: the larger of the bytes it
must move over 3.35 TB/s and its FP32 operations (from its counters) over
67 TFLOP/s; the last line is {"ok": true, "device": {...}}.  Any failure
exits non-zero, and so does a machine without CUDA.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

RTOL, ATOL, BDPT_ATOL, MIN_FRAC = 1e-4, 1e-6, 1e-5, 0.999
# the H100 SXM's published peaks: HBM bytes/s
# and FP32 operations/s outside the tensor cores
HBM_BPS, FP32_OPS = 3.35e12, 67e12
# FP32 operations of one Möller–Trumbore test (common.cuh: 2 crosses, 4
# dots, a reciprocal, 3 subtractions, 7 acceptance compares) and of one
# node's slab test (pt_wave.cu: 12 for the three axes' t0/t1, 6 min/max,
# 6 for entry and exit, 1 compare); the kernels' counters say how many ran
MT_OPS, SLAB_OPS = 52, 25
# FP32 operations one Plücker triangle test needs (plucker.cu): the three
# edge rows' 6 nonzero terms each, 33; the plane row's 3 terms and its
# constant, 6; the sign tests, reciprocal, t and the interval, 23.  Both
# Plücker kernels read a triangle's 22 nonzero coefficients and add each
# row's zero products once (a lane-serial sum over the [C, 128, 10] rows,
# as the plain version runs it, takes 99)
PLUCKER_OPS = 62
COFFEE_YAML = "scenes/coffee/coffee_standin.yaml"
TPU_BENCH_COFFEE_RAYS = 11_110_273  # BENCH_r03/r04.json; printed, not checked
# tools/coffee_reference_rays.py on a CPU, every 257th pixel x 16 strata:
# bpt_tpu's BVH path and its Pallas pt_wave
CPU_BVH_COFFEE_SUBSET, CPU_PALLAS_COFFEE_SUBSET = 44_024, 42_887
# coffee 512x512 / 4 spp / d10 / seed 0 BDPT-MIS: rays, shadow rays of the
# TPU runs of BENCH_r04.json (printed, not checked).  Every 257th pixel x 4
# strata, on a CPU (tools/coffee_reference_rays_bdpt.py): bpt_tpu's route
# for it there (the jnp stratum loop over its BVH walk) and the port's plain
# version of its route.  bdpt's shadow rays differ between the two by
# connections between two points of the floor plane, which carry no
# radiance (ROADMAP §3), so that one count is held against the port's own
CPU_COFFEE_BDPT_SUBSET = {"bdpt-mis": (16_447, 2_623), "bdpt": (16_447, 3_155)}
CPU_PLAIN_COFFEE_BDPT_SHADOW = {"bdpt-mis": 2_627, "bdpt": 3_064}
# the same subset of bdpt-mis through the clustered hit kernels, on a CPU
# (tools/coffee_reference_rays_clustered.py): bpt_tpu's TPU route forced
# there with its Pallas kernels in interpret mode under BPT_TPU_NO_FTB=1
# (rolled) and BPT_TPU_WAVE_IMPL=plucker, and the port's plain route
CPU_CLUSTERED_COFFEE_SUBSET = {"rolled": (16_784, 2_690), "plucker": (16_777, 2_692)}
CPU_PLAIN_CLUSTERED_COFFEE = {"rolled": (16_784, 2_688), "plucker": (16_784, 2_686)}
TPU_BENCH_COFFEE_BDPT_MIS = (4_294_700, 695_189)
# the reference binary's own BDPT configuration (tests/test_ref_rmse.py:
# 88-94): cornell 256x256 / 64 spp / d10 / seed 0 with ref_vis, through the
# stratum loop and the brute-force hit kernels.  Its image is held within
# bpt_tpu's own bound (test_ref_rmse.py:107) of the binary's PNG; every
# 257th pixel x 64 strata on a CPU (tools/cornell_reference_rays_refvis.py):
# bpt_tpu's route there (rays, shadow rays, mean radiance) and the port's
# plain route's shadow rays
REF_BDPT_PNG = "tests/golden/ref_binary/ref_bdpt_256_64.png"
REF_RMSE_BOUND = 0.045
CPU_REFVIS_SUBSET = (169_385, 109_805, 0.186788)
CPU_PLAIN_REFVIS_SHADOW = 106_309
# the fused BDPT kernels' stream on every 257th pixel x 4 strata of coffee
# 512x512 / d10 / seed 0, on a CPU (tools/coffee_reference_rays_fused.py):
# bpt_tpu's jnp estimator fed that stream (rays, shadow rays) and the port's
# plain fused kernel (shadow rays; bdpt's differ from bpt_tpu's by the floor
# plane's connections, ROADMAP §3, so bdpt's are held against the port's)
CPU_FUSED_COFFEE_SUBSET = {"bdpt-mis": (16_359, 2_727), "bdpt": (16_359, 3_219)}
CPU_PLAIN_FUSED_COFFEE_SHADOW = {"bdpt-mis": 2_726, "bdpt": 3_189}
# the coffee bdpt-mis 512x512 / 4 spp / d80 render through the BDPT wave
# loop (PERF.md, Findings): wall seconds and peak device GiB
WAVE_D80_WALL, WAVE_D80_PEAK_GIB = 37.145, 18.17
WALK_KERNELS = ("pt_megakernel_walk", "pt_megakernel_pixels_walk", "bdpt_megakernel_walk",
                "bdpt_megakernel_pixels_walk")
EXPECTED_RAYS = 11_506_161  # bpt_tpu fused kernel, interpret mode on a CPU
TPU_BENCH_RAYS = 11_497_620  # BENCH_r02..r04.json; printed, not checked
# cornell 512x512 / 16 spp / d10 / seed 0: rays, shadow rays.  The TPU
# runs of BENCH_r04.json, and bpt_tpu's fused kernel in interpret mode on a
# CPU (tools/pt_reference_rays.py --integrator ...); printed, not checked
TPU_BENCH_BDPT = {"bdpt": (40_468_228, 57_164_656),
                  "bdpt-mis": (40_468_228, 49_503_600)}
CPU_REF_BDPT = {"bdpt": (40_532_450, 56_644_333),
                "bdpt-mis": (40_532_450, 49_893_268)}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def agreement(got, want, atol=ATOL):
    """(fraction of lanes within tolerance on all channels, max abs err,
    index of the lane whose error uses the most of its tolerance) of [B,3]
    kernel vs plain radiance."""
    err = (got - want).abs()
    used = (err / (atol + RTOL * want.abs())).max(dim=1).values
    ok = used <= 1.0
    worst = int(used.argmax())
    return float(ok.double().mean()), float(err.max()), worst


def counters(out):
    """[rays, nodes, aabb, tri tests, tri hits] of a PT kernel's outputs,
    [rays, shadow, nodes, aabb, tri tests, tri hits] of a BDPT kernel's."""
    return [int(x) for x in out[3:-1]] + [int(x) for x in out[-1]]


def compare(name, kernel_out, plain_out, exact_counts: bool, atol=ATOL):
    import torch

    got = torch.stack(kernel_out[:3], dim=1)
    want = torch.stack(plain_out[:3], dim=1)
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel radiance")
    frac, max_err, worst = agreement(got, want, atol)
    kc, pc = counters(kernel_out), counters(plain_out)
    names = "rays, nodes, aabb" if len(kc) == 5 else "rays, shadow, nodes, aabb"
    print(f"{name}: {frac * 100:.4f}% of {got.shape[0]} lanes within rtol "
          f"{RTOL} / atol {atol}; max abs err {max_err:.3e}; worst lane "
          f"{worst}: kernel {got[worst].tolist()} plain {want[worst].tolist()}; "
          f"counters ({names}, tri tests, tri hits) kernel {kc} plain {pc}")
    check(frac >= MIN_FRAC, f"{name}: only {frac:.5f} of lanes agree")
    if exact_counts:
        check(kc == pc, f"{name}: counters differ: kernel {kc} plain {pc}")
    return frac, max_err


def _gap(n: int, tpu: int, cpu: int) -> str:
    return (f"TPU bench {tpu}, {(n - tpu) / tpu * 100:+.4f}%; bpt_tpu on a CPU "
            f"{cpu}, {(n - cpu) / cpu * 100:+.4f}%")


def time_ms(fn, reps: int) -> float:
    """Mean ms per call between CUDA events after one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def timed(fn):
    """(fn(), ms) of one call between CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def cl_agreement(kout, pout):
    """(lanes equal within 1e-6 as a fraction, max abs err, hits) of a
    clustered hit kernel's outputs against its plain version's, (hit,
    counters) or (t, tri, u, v, counters): the any answer exactly; for the
    closest hit, triangle exact and t, u, v within 1e-6 (t equal where the
    plain version misses)."""
    import torch

    if len(kout) == 2:
        same = kout[0] == pout[0]
        return float(same.double().mean()), float((~same).float().max()), int(kout[0].sum())
    hit = pout[1] >= 0
    diffs = [(k - p).abs() for k, p in zip((kout[0], *kout[2:4]), (pout[0], *pout[2:4]))]
    diffs[0] = torch.where(hit, diffs[0], (kout[0] != pout[0]).float())
    same = (kout[1] == pout[1]) & torch.stack(diffs).amax(dim=0).le(1e-6)
    err = max(float(x[hit].max()) if bool(hit.any()) else 0.0 for x in diffs)
    return float(same.double().mean()), err, int(hit.sum())


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it)."""
    b, o = nbytes / HBM_BPS * 1e3, ops / FP32_OPS * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def closest_bytes(active) -> int:
    """Bytes a ``closest_bvh`` call must move besides the scene: every lane
    reads its mask byte and writes t, tri, u, v; a live lane also reads its
    origin and direction."""
    return int(active.shape[0]) * (1 + 4 * 4) + int(active.sum()) * 6 * 4


def any_bytes(tmax) -> int:
    """Bytes an ``any_bvh`` call must move besides the scene: every lane
    reads its tmax and writes its answer byte; a live lane (tmax > 0) also
    reads its origin and direction."""
    return int(tmax.shape[0]) * (4 + 1) + int((tmax > 0).sum()) * 6 * 4


def tri_soup(n, seed, dev, dtype):
    """n random triangles in the cornell box's bounds under a quad light
    of the box's size: n + 2 triangles, no BVH up to n = 254."""
    import numpy as np

    from bpt_tpu_torch.scene.builder import MaterialSpec as MS, SceneBuilder

    g = np.random.default_rng(seed)
    b = SceneBuilder()
    for _ in range(n):
        p = g.uniform(0, 555, 3)
        b.add_triangle(tuple(p), tuple(p + g.normal(0, 60, 3)), tuple(p + g.normal(0, 60, 3)),
                       MS.lambertian((0.7, 0.7, 0.7)))
    b.add_quad((0, 555, 0), (555, 0, 0), (0, 0, 555), MS.diffuse_light((4, 4, 4)))
    return b.build(device=dev, dtype=dtype)


def tri_lanes(B, seed, dev, dtype):
    """Random rays in the cornell box with per-lane [tmin, tmax]: one lane
    in five dead (tmax < tmin), one in seven running to inf."""
    import numpy as np
    import torch

    from bpt_tpu_torch.core.vec3 import Vec3

    g = np.random.default_rng(seed)
    o = torch.from_numpy(g.uniform(50, 500, (B, 3))).to(dev, dtype)
    d = torch.from_numpy(g.normal(size=(B, 3))).to(dev, dtype)
    tmin = torch.from_numpy(g.uniform(0.0, 50.0, B)).to(dev, dtype)
    tmax = tmin + torch.from_numpy(g.uniform(-200.0, 900.0, B)).to(dev, dtype)
    tmax[::7] = torch.inf
    return Vec3(*o.unbind(1)), Vec3(*d.unbind(1)), tmin, tmax


def compare_tri(name, scene, o, d, tmin, tmax, card):
    """closest_tri / any_tri against their plain versions on the same
    lanes: hit, triangle and any-answer must be equal, t, u, v within 1e-6.
    Returns (max abs err of t, u, v on hits; share of lanes equal)."""
    import torch

    from bpt_tpu_torch.ops.kernels import intersect as ki

    kout = ki.closest_tri(scene, o, d, tmin, tmax)
    pout = ki.closest_tri_plain(scene, o, d, tmin, tmax)
    hit_k = ki.any_tri(scene, o, d, tmin, tmax)
    hit_p = ki.any_tri_plain(scene, o, d, tmin, tmax)
    torch.cuda.synchronize()
    hit = pout[1] >= 0
    same = (kout[1] == pout[1]) & (hit_k == hit_p)
    err = max(float((k - p)[hit].abs().max()) if bool(hit.any()) else 0.0
              for k, p in zip(kout[0:1] + kout[2:], pout[0:1] + pout[2:]))
    B, live = int(hit.shape[0]), int((tmin <= tmax).sum())
    print(f"{name}: B={B} ({live} live), closest hits {int(hit.sum())}, any hits "
          f"{int(hit_p.sum())}; tri and any-answer equal on "
          f"{float(same.double().mean()) * 100:.4f}% of lanes; t, u, v max abs err {err:.3e}; "
          f"misses t = inf {bool(kout[0][~hit].isinf().all())} ({card})")
    check(bool(same.all()), f"{name}: tri or any-answer differ from the plain versions")
    check(torch.equal(kout[0][~hit], pout[0][~hit]), f"{name}: a miss's t differs")
    check(err <= 1e-6, f"{name}: t, u, v differ by {err:.3e}")
    return err, float(same.double().mean())


def any_tests(scene, o, d, tmin, tmax, chunk=1 << 21) -> int:
    """Möller–Trumbore tests ``any_tri`` runs on these lanes: a live lane
    stops at its first hit (index + 1 tests), a lane without a hit tests
    every triangle, a dead lane none."""
    import torch

    from bpt_tpu_torch.ops import soa

    T, n = scene.num_tris, 0
    idx = torch.arange(1, T + 1, device=tmin.device)[:, None]
    for k in range(0, int(tmin.shape[0]), chunk):
        sl = slice(k, k + chunk)
        oc, dc = (type(o)(*(c[sl] for c in v)) for v in (o, d))
        det, t, u, v = soa._mt_all(scene.v0, scene.e1, scene.e2, oc, dc)
        ok = soa._mt_valid(det, t, u, v, tmin[sl][None], tmax[sl][None])
        first = torch.where(ok, idx, T).amin(dim=0)
        n += int(torch.where(tmin[sl] <= tmax[sl], first, 0).sum())
    return n


@contextlib.contextmanager
def walks_on_kernels():
    """The plain versions' BVH walks on the CUDA walks closest_bvh / any_bvh
    while the block runs: they equal the torch walks on every lane,
    counters included (phases 5, 6 and 10), so the plain estimators run at
    the coffee stand-in's real shapes, where the torch walks take 10-15 s
    a bounce."""
    from bpt_tpu_torch.ops import soa

    route = soa._kernel_route
    soa._kernel_route = lambda scene, plain: scene.use_bvh and scene.device.type == "cuda"
    try:
        yield
    finally:
        soa._kernel_route = route


def big_builder(spheres=1):
    """The SceneBuilder of tests/torch_parity.py::big_scene: a metal UV
    sphere (``spheres`` times over, in one place) on a floor under a quad
    light."""
    from bpt_tpu_torch.scene.builder import MaterialSpec as MS, SceneBuilder

    b = SceneBuilder()
    for _ in range(spheres):
        b.add_uv_sphere((0, 1, 0), 1.0, MS.metal((0.8, 0.8, 0.8), 0.05))
    b.add_quad((-10, 0, -10), (20, 0, 0), (0, 0, 20), MS.lambertian((0.6, 0.6, 0.6)))
    b.add_quad((-2, 6, -2), (4, 0, 0), (0, 0, 4), MS.diffuse_light((10, 10, 10)))
    return b


def big_scene(dev):
    """tests/torch_parity.py::big_scene: 964 triangles, over the
    brute-force mode's 512."""
    return big_builder().build(device=dev)


def cluster_bound(name, c, lanes_b, live, tab_bytes, slabs=None) -> tuple[float, str]:
    """(bound ms, by) of a clustered hit launch with counters c (slab
    tests, boxes entered, triangle tests, accepted tests): every lane reads
    its tmax and writes its answer (1 B any, 16 B closest), a live lane
    reads its ray and tmin; the tables (tab_bytes) once; 25 FP32 operations
    a slab test, 52 a Möller–Trumbore test, 62 a Plücker test (what it
    needs: PLUCKER_OPS) and 21 a Plücker cluster's features.  ``slabs``,
    where given, replaces c[0] as the slab tests the launch needs
    (plucker_closest_needs, plucker_any_needs)."""
    out = 1 if name.endswith("any") else 16
    n_slab = c[0] if slabs is None else slabs
    ops = (n_slab * SLAB_OPS + c[1] * 21 + c[2] * PLUCKER_OPS
           if name.startswith("plucker") else n_slab * SLAB_OPS + c[2] * MT_OPS)
    return bound(lanes_b * (4 + out) + live * 7 * 4 + tab_bytes, ops)


def chop_groups_entered(aabb, o, d, tmax, lim, group=16, chunk=1 << 16):
    """The groups of ``group`` consecutive chop boxes of ``aabb`` [C*6] (the
    Plücker kernels' second level, built here from ``aabb``, so that a copy
    of the package whose tables have no groups is counted alike) that each
    live lane (tmax > 0) enters with the bound ``lim`` (one a live lane),
    the entry clamped to T_MIN and NaN slab terms unconstrained.  Yields
    (members of each group [G], first live lane of the chunk, entered [n,
    G]) for each chunk of live lanes."""
    import torch

    from bpt_tpu_torch.ops.intersect import T_MIN

    box = aabb.reshape(-1, 6)
    C = box.shape[0]
    G = -(-C // group)
    pad = torch.tensor([math.inf] * 3 + [-math.inf] * 3, device=box.device)
    gb = torch.cat([box, pad.expand(G * group - C, 6)]).reshape(G, group, 6)
    glo, ghi = gb[:, :, :3].amin(dim=1), gb[:, :, 3:].amax(dim=1)
    members = torch.clamp(C - group * torch.arange(G, device=box.device), max=group)
    live = tmax > 0
    org = torch.stack(list(o), dim=1)[live]
    inv = 1.0 / torch.stack(list(d), dim=1)[live]
    for s in range(0, org.shape[0], chunk):
        og, iv = org[s:s + chunk, None], inv[s:s + chunk, None]
        t0, t1 = (glo[None] - og) * iv, (ghi[None] - og) * iv
        nan = torch.isnan(t0) | torch.isnan(t1)
        lo = torch.where(nan, -math.inf, torch.minimum(t0, t1)).amax(dim=2)
        hi = torch.where(nan, math.inf, torch.maximum(t0, t1)).amin(dim=2)
        yield members, s, torch.minimum(hi, lim[s:s + chunk, None]) > torch.clamp_min(lo, T_MIN)


def plucker_table_bytes(aabb, group=16) -> int:
    """Bytes of the Plücker kernels' tables over the chop boxes ``aabb``
    [C*6], each read once: the chop and group boxes and the 22
    coefficients of each of a cluster's 32 slots (ops/plucker.py's
    ``table`` and ``packed``)."""
    C = aabb.numel() // 6
    return 4 * (6 * (C + -(-C // group)) + 22 * 32 * C)


def plucker_closest_needs(aabb, o, d, tmax, t, group=16, chunk=1 << 16) -> tuple[int, int]:
    """(slab tests, table bytes) that plucker_closest needs for one launch
    over the chop boxes ``aabb`` [C*6]: a live lane (tmax > 0) slab-tests
    the ceil(C / group) group boxes, each the min / max of ``group``
    consecutive chop boxes, and the chop boxes of each group whose box it
    enters with the bound min(t, tmax), t its closest hit (inf on a miss):
    a search that ends at t must open each such group to show that nothing
    in it is closer.  The kernel counts C slab tests a lane, as the
    lane-serial loop ran them, and skips only groups that no lane of a warp
    enters, so it runs at least these.  The table bytes:
    plucker_table_bytes."""
    import torch

    live = tmax > 0
    lim = torch.minimum(t[live], tmax[live])
    slabs = 0
    for members, _, ok in chop_groups_entered(aabb, o, d, tmax, lim, group, chunk):
        slabs += ok.numel() + int((ok.to(torch.int64) * members).sum())
    return slabs, plucker_table_bytes(aabb, group)


def plucker_any_needs(aabb, o, d, tmax, tri, group=16, chunk=1 << 16) -> tuple[int, int]:
    """(slab tests, table bytes) that plucker_any needs for one launch over
    the chop boxes ``aabb`` [C*6]: a live lane (tmax > 0) whose first hit in
    chop-cluster order is triangle ``tri`` (-1 for none: the plain
    traversal's ``Lanes.tri``), in chop cluster k = tri // 32 and so in
    group k // group, slab-tests the group boxes up to k's group (all
    ceil(C / group) without a hit) and, of each of them whose box it enters
    with the bound tmax, the chop boxes: all of them before k's group, up to
    k in it.  The kernel counts k + 1 (or C) slab tests a lane, as the
    lane-serial loop ran them.  The table bytes: plucker_table_bytes."""
    import torch

    live = tmax > 0
    k_hit = tri[live].to(torch.int64) // 32
    slabs = 0
    for members, s, ok in chop_groups_entered(aabb, o, d, tmax, tmax[live], group, chunk):
        G = members.numel()
        k = k_hit[s:s + ok.shape[0], None]
        g = torch.arange(G, device=ok.device)[None]
        hit_g = torch.where(k >= 0, k // group, G)  # G: no hit, every group
        tested = torch.where(g < hit_g, members[None],
                             torch.where(g == hit_g, k - group * g + 1, 0))
        slabs += int(torch.clamp(hit_g + 1, max=G).sum()) + int((ok * tested).sum())
    return slabs, plucker_table_bytes(aabb, group)


def cluster_ptxas(lines) -> dict:
    """ptxas's registers and spill bytes of the four clustered hit kernels
    (cluster_closest<RolledMT | PluckerChop>, cluster_any<...>, the any
    hits' name whether they take the compacted lanes or a thread a lane; an
    earlier build's cluster_hit<..., false> and cluster_hit<..., true> for
    the closest and any hits) in the lines of a build's log:
    {"clustered_closest": {...}, ..., "plucker_any": {...}}."""
    import re

    out = {}
    for k, line in enumerate(lines):
        m = re.search(r"entry function '(_ZN3bpt(11cluster_hit|11cluster_any|15cluster_closest)"
                      r"INS_\d+(RolledMT|PluckerChop)E(Lb([01])E)?\S*)'", line)
        if not m:
            continue
        text = " ".join(lines[k + 1:k + 5])
        regs = re.search(r"Used (\d+) registers", text)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)
        name = (("clustered" if m.group(3) == "RolledMT" else "plucker")
                + ("_any" if m.group(2) == "11cluster_any" or m.group(5) == "1" else "_closest"))
        out[name] = dict(kernel=m.group(1), registers=int(regs.group(1)) if regs else None,
                         spill_bytes=[int(x) for x in spill.groups()] if spill else None)
    return out


def dup_scene(dev):
    """big_scene with its UV sphere added twice: each sphere triangle has an
    identical twin beside it in BVH leaf order, mostly in the same cluster,
    so a ray through the sphere meets candidates of equal t (ties)."""
    return big_builder(spheres=2).build(device=dev)


OVERFLOW_TRIANGLE = ((-1e12, -1e12, 3e11), (1e12, -2e11, -1e12), (-1e11, 1e12, 1e12))


def overflow_scene(dev):
    """big_scene with one more triangle, tilted, of edges ~2e12: a ray of
    length 1e-31 aimed at it from 1e9 away (overflow_lane) meets it at t ~
    1e40, which overflows to +inf in float32 while the Plücker test's
    denominator (~5e-7) passes MT_EPSILON and its signs agree."""
    from bpt_tpu_torch.scene.builder import MaterialSpec as MS

    b = big_builder()
    b.add_triangle(*OVERFLOW_TRIANGLE, MS.lambertian((0.5, 0.5, 0.5)))
    return b.build(device=dev)



def overflow_lane():
    """(origin, direction) [3] float32 of overflow_scene's lane: 1e9 off
    the big triangle's centroid along its normal, aimed back at it with a
    direction of length 1e-31 (each component a normal float)."""
    import numpy as np

    a, b, c = (np.array(v) for v in OVERFLOW_TRIANGLE)
    n = np.cross(b - a, c - a)
    n /= np.linalg.norm(n)
    return ((a + b + c) / 3 + 1e9 * n).astype(np.float32), (-1e-31 * n).astype(np.float32)


def cluster_edge_lanes(coffee, dup, seed=5) -> dict:
    """The clustered hits' edge cases, {name: (scene, o, d, tmin, tmax)},
    numpy-seeded: random rays in the coffee stand-in's bounds with per-lane
    intervals at B = 1, 31 and 37; all lanes dead; one live lane a warp;
    rays at the duplicated sphere of ``dup`` (equal-t ties); origins on a
    plane of a chop cluster's and of a rolled cluster's box with that axis'
    direction component zero (NaN slab terms); tmin below T_MIN (0 or
    negative: Plücker's hits in [tmin, T_MIN)); tmax = inf on every lane;
    and on overflow_scene (on ``dup``'s device) a warp of random rays about
    the sphere whose lane 0 is overflow_lane, tmax = inf: its Plücker t
    overflows to +inf, which the plain version's t < inf refuses."""
    import numpy as np
    import torch

    from bpt_tpu_torch.core.vec3 import Vec3
    from bpt_tpu_torch.ops.clusters import cluster_tables
    from bpt_tpu_torch.ops.intersect import T_MIN
    from bpt_tpu_torch.ops.plucker import plucker_tables

    dev = coffee.device
    g = np.random.default_rng(seed)
    lo, hi = (x.cpu().numpy() for x in (coffee.bvh_min[0], coffee.bvh_max[0]))
    diag = float(np.linalg.norm(hi - lo))

    def rays(B):
        return (g.uniform(lo, hi, (B, 3)).astype(np.float32),
                g.normal(size=(B, 3)).astype(np.float32))

    def intervals(B):
        tmin = np.where(g.uniform(size=B) < 0.5, g.uniform(0.0, 0.1, B), T_MIN)
        tmax = tmin + g.uniform(0.0, diag, B)
        tmax[::5] = np.inf
        return tmin.astype(np.float32), tmax.astype(np.float32)

    def case(scene, o, d, tmin, tmax):
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)
        return (scene, Vec3(*t(o).unbind(1)), Vec3(*t(d).unbind(1)), t(tmin), t(tmax))

    out = {}
    for B in (1, 31, 37):
        out[f"B={B}"] = case(coffee, *rays(B), *intervals(B))
    B = 2048
    o, d = rays(B)
    tmin, tmax = intervals(B)
    out["all dead"] = case(coffee, o, d, tmin, np.where(np.arange(B) % 2, 0.0, -1.0))
    one = np.where(np.arange(B) % 32 == (np.arange(B) // 32) % 32, tmax, 0.0)
    out["one live lane a warp"] = case(coffee, o, d, tmin, one)
    c = np.array([0.0, 1.0, 0.0])
    u = g.normal(size=(B, 3))
    od = (c + 3.0 * u / np.linalg.norm(u, axis=1, keepdims=True)).astype(np.float32)
    dd = (c + g.uniform(-0.5, 0.5, (B, 3)) - od).astype(np.float32)
    out["duplicated triangles"] = case(dup, od, dd, np.full(B, T_MIN, np.float32),
                                       np.full(B, np.inf, np.float32))
    o, d = rays(B)
    chop = plucker_tables(coffee).aabb.reshape(-1, 6).cpu().numpy()
    tab = cluster_tables(coffee)
    recs = tab.table[8 * tab.n_super:].reshape(-1, 7)[:, :6].cpu().numpy()
    boxes = np.concatenate([chop[g.integers(0, len(chop), B // 2)],
                            recs[g.integers(0, len(recs), B - B // 2)]])
    for k in range(B):
        a = k % 3
        o[k, a] = boxes[k, a + 3 * (k // 3 % 2)]  # the box's lo or hi plane
        d[k, a] = 0.0
    out["zero direction on a box plane"] = case(coffee, o, d, *intervals(B))
    o, d = rays(B)
    tmin = np.where(np.arange(B) % 3 == 0, 0.0, g.uniform(-0.05, T_MIN, B)).astype(np.float32)
    out["tmin below T_MIN"] = case(coffee, o, d, tmin, intervals(B)[1])
    o, d = rays(B)
    out["tmax = inf"] = case(coffee, o, d, np.full(B, T_MIN, np.float32),
                             np.full(B, np.inf, np.float32))
    B = 32
    o = g.uniform(-3.0, 3.0, (B, 3)).astype(np.float32)
    d = g.normal(size=(B, 3)).astype(np.float32)
    o[0], d[0] = overflow_lane()
    out["t overflows"] = case(overflow_scene(dup.device), o, d, np.full(B, T_MIN, np.float32),
                              np.full(B, np.inf, np.float32))
    return out


def bits_differ(kout, pout):
    """[B] bool: the lanes where any of the outputs, (t, tri, u, v) or the
    any answer, differs in any bit."""
    import torch

    diff = torch.zeros_like(kout[0], dtype=torch.bool)
    for k, p in zip(kout, pout):
        if k.dtype == torch.float32:
            k, p = k.view(torch.int32), p.view(torch.int32)
        diff |= k != p
    return diff


def cluster_edge_phase(dev, card, coffee) -> dict:
    """Phase 21b: the four clustered hits, warp-wide, against their plain
    versions on cluster_edge_lanes' cases, every output (t, tri, u, v or the
    any answer) to the bit and the counters exact; and each kernel's whole
    launch of the "tmin below T_MIN" case against its launches on every 3rd
    and every 7th lane.  Returns {kernel: {case: (B, live, hits,
    counters)}}."""
    import torch

    from bpt_tpu_torch.core.vec3 import Vec3
    from bpt_tpu_torch.ops import soa
    from bpt_tpu_torch.ops.intersect import T_MIN
    from bpt_tpu_torch.ops.kernels import cluster_wave as cw
    from bpt_tpu_torch.ops.kernels import plucker as kp

    cases = cluster_edge_lanes(coffee, dup_scene(dev))
    scene, o, d, tmin, tmax = cases["duplicated triangles"]
    det, t, u, v = soa._mt_all(scene.v0, scene.e1, scene.e2, o, d)
    tm = torch.where(soa._mt_valid(det, t, u, v, T_MIN, torch.inf), t, torch.inf)
    best = tm.amin(dim=0)
    ties = int(((tm == best[None]).sum(dim=0) >= 2)[torch.isfinite(best)].sum())
    print(f"phase 21b: the duplicated sphere ({scene.num_tris} triangles): {ties} of "
          f"{best.numel()} lanes meet two or more triangles at their closest t")
    check(ties > 0, "phase 21b: no lane of the duplicated-triangle case meets a tie")
    report = {}
    for name, kern, plain in (
            ("clustered_closest", cw.clustered_closest, cw.clustered_closest_plain),
            ("plucker_closest", kp.plucker_closest, kp.plucker_closest_plain),
            ("clustered_any", cw.clustered_any, cw.clustered_any_plain),
            ("plucker_any", kp.plucker_any, kp.plucker_any_plain)):
        rep = report[name] = {}
        for case, (scene, o, d, tmin, tmax) in cases.items():
            kout = kern(scene, o, d, tmin, tmax)
            pout = plain(scene, o, d, tmin, tmax)
            diff = int(bits_differ(kout[:-1], pout[:-1]).sum())
            kc, pc = kout[-1].tolist(), pout[-1].tolist()
            B, live = tmax.numel(), int((tmax > 0).sum())
            hits = int(pout[0].sum()) if len(pout) == 2 else int((pout[1] >= 0).sum())
            print(f"phase 21b: {name} {case} (B={B}, {live} live, {hits} hits): {diff} lanes "
                  f"differ in any bit from the plain version; counters kernel {kc} plain {pc}")
            check(diff == 0 and kc == pc, f"{name} {case}: {diff} lanes differ, counters "
                  f"kernel {kc} plain {pc}")
            rep[case] = (B, live, hits, kc)
        scene, o, d, tmin, tmax = cases["tmin below T_MIN"]
        full = kern(scene, o, d, tmin, tmax)
        for s in (3, 7):
            sl = torch.arange(0, tmax.numel(), s, device=dev)
            sub = kern(scene, Vec3(*(x[sl] for x in o)), Vec3(*(x[sl] for x in d)), tmin[sl],
                       tmax[sl])
            n = int(bits_differ([x[sl] for x in full[:-1]], sub[:-1]).sum())
            print(f"phase 21b: {name}: its launch on one lane in {s} of the tmin-below-T_MIN "
                  f"case differs from the whole launch on {n} lanes ({card})")
            check(n == 0, f"{name}: a strided launch differs from the whole launch")
    return report


def walk_table_bytes(scene, bdpt=False) -> int:
    """Bytes of the scene a walk-mode megakernel reads: the BVH's nodes and
    triangles, the material ids and the shading tables."""
    from bpt_tpu_torch.ops.kernels import bdpt_kernel as bk
    from bpt_tpu_torch.ops.kernels import pt_kernel as pk
    from bpt_tpu_torch.ops.kernels.pt_wave import walk_tables

    shade = (bk._pack_tables_bdpt(scene) if bdpt else pk._pack_tables(scene))[2:]
    return (sum(t.numel() * t.element_size() for t in (*walk_tables(scene), *shade))
            + 4 * scene.num_tris)


def coffee_builder():
    """scenes/coffee/coffee_standin.yaml through SceneBuilder calls: its
    materials (the loader's 0-255 autoscale), its five OBJ meshes and its
    three light quads, in the file's order."""
    from bpt_tpu_torch.scene.builder import MaterialSpec as MS, SceneBuilder
    from bpt_tpu_torch.scene.loader import read_color_scaled

    def rgb(c):
        return read_color_scaled(c, (0.0, 0.0, 0.0))

    b = SceneBuilder()
    for name, mat in (("Plastic_Orange", MS.lambertian(rgb([255, 97, 3]))),
                      ("Plastic_Black", MS.lambertian(rgb([0, 0, 0]))),
                      ("Metal", MS.metal(rgb([170, 170, 170]), 0.1)),
                      ("Glass", MS.dielectric(1.5)),
                      ("Floor", MS.lambertian(rgb([147, 147, 147])))):
        b.add_obj(f"scenes/coffee/data/{name}.obj", mat)
    light = MS.diffuse_light((245.0, 245.0, 245.0))
    for q in ([(-0.359309, 0.449693, -0.010809), (-0.196537, 0.449693, 0.338256),
               (-0.196537, 0.000849009, 0.338256), (-0.359309, 0.000848979, -0.010809)],
              [(0.320673, 0.027337, 0.228975), (0.320673, 0.476182, 0.228975),
               (0.325221, 0.476182, -0.136419), (0.325221, 0.027337, -0.136419)],
              [(0.230128, 0.50385, 0.267372), (-0.230128, 0.50385, 0.267372),
               (-0.230128, 0.50385, -0.192885), (0.230128, 0.50385, -0.192885)]):
        b.add_triangle(q[0], q[1], q[2], light)
        b.add_triangle(q[0], q[2], q[3], light)
    return b


def coffee_camera(width=512, spp=16, depth=10, integrator="pt"):
    """The YAML's camera at bench.py's coffee cells: 512x512, depth 10, PT
    at 16 spp (bdpt-mis at 4)."""
    from bpt_tpu_torch.scene.types import CameraConfig

    return CameraConfig(aspect_ratio=1.0, image_width=width, samples_per_pixel=spp,
                        max_depth=depth, vfov=30.0, lookfrom=(-0.02, 0.22, 0.85),
                        lookat=(0.0, 0.16, 0.02), file_name="coffee_standin.png",
                        integrator=integrator)


@contextlib.contextmanager
def capture(module, name, keep=None):
    """Records the arguments of the calls of ``module.<name>`` made while
    the block runs (only the calls numbered in ``keep``, if given) as
    {call number: (args, kwargs)}; the calls themselves go through."""
    fn = getattr(module, name)
    calls, n = {}, [0]

    def spy(*args, **kw):
        if keep is None or n[0] in keep:
            calls[n[0]] = (args, kw)
        n[0] += 1
        return fn(*args, **kw)

    spy.__dict__.update(fn.__dict__)  # a wrapper counts its launches on its own name
    setattr(module, name, spy)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def tri_dense(scene, o, d, tmin, tmax):
    """The lanes of a ``closest_tri`` / ``any_tri`` call as the kernels
    read them: contiguous [B] tensors of the scene's dtype (a call's tmin
    may be a broadcast scalar)."""
    import torch

    from bpt_tpu_torch.core.vec3 import Vec3

    def dense(x):
        return torch.broadcast_to(torch.as_tensor(x, dtype=scene.dtype, device=scene.device),
                                  o.x.shape).contiguous()

    return scene, Vec3(*map(dense, o)), Vec3(*map(dense, d)), dense(tmin), dense(tmax)


def tri_bound(name, scene, o, d, tmin, tmax):
    """(bound ms, what bounds it) of one ``closest_tri`` / ``any_tri``
    launch on these lanes: every lane reads its interval and writes its
    answer (t, tri, u, v; or a byte), a live lane also reads its origin and
    direction, the table is read once; the closest hit runs T tests a live
    lane, the any hit what ``any_tests`` counts."""
    e = tmin.element_size()
    B, live = int(tmin.shape[0]), int((tmin <= tmax).sum())
    table = scene.num_tris * 9 * e
    if name == "closest_tri":
        return bound(B * (2 * e + 3 * e + 4) + live * 6 * e + table,
                     live * scene.num_tris * MT_OPS)
    return bound(B * (2 * e + 1) + live * 6 * e + table,
                 any_tests(scene, o, d, tmin, tmax) * MT_OPS)


@contextlib.contextmanager
def tri_launch_times(module, name, keep=()):
    """While the block runs, each call of ``module.<name>`` (closest_tri
    or any_tri) is timed on its own inputs before it goes through (mean of
    3 calls after a warm-up) and bounded: yields {"launches": [(B, live,
    ms, bound ms)], "kept": {call number: its dense inputs}} for the calls
    numbered in ``keep``.  One launch's inputs at a time: a ref_vis
    render's ten shadow waves would hold about 13 GB."""
    fn = getattr(module, name)
    out = {"launches": [], "kept": {}}

    def spy(*args):
        a = tri_dense(*args)
        ms = time_ms(lambda: fn(*a), reps=3)
        out["launches"].append((int(a[3].shape[0]), int((a[3] <= a[4]).sum()), ms,
                                tri_bound(name, *a)[0]))
        if len(out["launches"]) - 1 in keep:
            out["kept"][len(out["launches"]) - 1] = a
        return fn(*args)

    spy.__dict__.update(fn.__dict__)  # a wrapper counts its launches on its own name
    setattr(module, name, spy)
    try:
        yield out
    finally:
        setattr(module, name, fn)


def tri_slice_vs_plain(name, what, args, stride, card):
    """A ref_vis launch of ``closest_tri`` / ``any_tri`` (``name``, on its
    dense inputs ``args``) against its plain version, which holds [T, B]
    temporaries, too much for 42M lanes: the whole launch's answers on
    every ``stride``-th lane are shown equal to the bit to that slice's own
    launch (a lane's answer depends on its own ray only), then the slice
    is held against both plain versions (``compare_tri``).  Returns (max
    abs err, share of lanes equal, the slice's kernel ms, its plain ms,
    lanes compared)."""
    import torch

    from bpt_tpu_torch.core.vec3 import Vec3
    from bpt_tpu_torch.ops.kernels import intersect as ki

    kernel, plain = getattr(ki, name), getattr(ki, f"{name}_plain")
    scene, o, d, tmin, tmax = args
    full = kernel(*args)
    full = full if isinstance(full, tuple) else (full,)
    sl = torch.arange(0, tmin.shape[0], stride, device=tmin.device)
    s_args = (scene, Vec3(*(x[sl] for x in o)), Vec3(*(x[sl] for x in d)), tmin[sl], tmax[sl])
    part = kernel(*s_args)
    part = part if isinstance(part, tuple) else (part,)
    check(all(torch.equal(a[sl], b) for a, b in zip(full, part)),
          f"{name}: its launch on every {stride}th lane differs from the whole launch there")
    del full
    e, f = compare_tri(f"phase 12: closest_tri / any_tri on every {stride}th lane of {what}, "
                       f"equal to the bit to the whole {name} launch there", *s_args, card)
    slice_ms = time_ms(lambda: kernel(*s_args), reps=10)
    _, plain_ms = timed(lambda: plain(*s_args))
    return e, f, slice_ms, plain_ms, int(sl.numel())


def shadow_lanes(args, kw):
    """(o, d, tmax) of a recorded ``ops.soa.any_hit`` call as ``any_bvh``
    takes them: a lane the mask leaves out is dead, with tmax 0."""
    import torch

    _, o, d, _, tmax = args
    return o, d, torch.where(kw["mask"], tmax, 0.0)


def wave_rays(cc, pix, strata, key, dev, first=0, bdpt=False):
    """The pt_wave render loop's primary rays for pixels ``pix`` and
    strata first..first+strata-1 (models/render.py::_render_wave): (o, d,
    ray ids).  ``bdpt``: on the BDPT kernel's raygen jitter instead, so
    the rays-mode plain version on them computes the pixels mode's
    samples."""
    import torch

    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.core.vec3 import Vec3
    from bpt_tpu_torch.models.camera import generate_rays

    S, W = cc.sqrt_spp, cc.width
    pixb = pix.repeat(strata)
    s = first + torch.arange(strata, device=dev).repeat_interleave(pix.numel())
    ids = pixb * (S * S) + s
    u0, u1 = (rng.bdpt_raygen_jitter if bdpt else rng.raygen_jitter)(key, ids)
    z = torch.zeros_like(u0)
    o3, d3 = generate_rays(cc, (pixb % W).float(), (pixb // W).float(), (s % S).float(),
                           (s // S).float(), torch.stack([u0, u1, z, z], -1))
    return Vec3(*o3.unbind(1)), Vec3(*d3.unbind(1)), ids.to(torch.int32)


def refill_cases(dev, card) -> dict:
    """closest_bvh and pt_wave_bounce (both modes) on big_scene's lanes at
    the shapes that exercise the persistent grid's refill: B = 1, 31 and
    37; 4 x the resident grid's threads and 5 more; every lane inactive;
    one live lane in ten scattered among 65,536, rays in random order.
    closest_bvh: t, tri, u, v and the counters equal to the plain
    version's to the bit.  pt_wave_bounce: the counters equal, a dead
    lane's rows copied to the bit (alive 0), the live lanes' rows equal to
    the bit to those of the same lanes launched alone, packed, and within
    rtol 1e-4 / atol 1e-6 of the plain version on >= 99.9% of lanes."""
    import numpy as np
    import torch

    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.core.vec3 import Vec3
    from bpt_tpu_torch.ops.kernels import build
    from bpt_tpu_torch.ops.kernels import pt_wave as pw

    scene = big_scene(dev)
    lib = build.load_library()
    with torch.cuda.device(dev):
        blocks = lib.bpt_wave_blocks()
    check(blocks > 0, f"closest_bvh's occupancy query failed: CUDA error {-blocks}")
    key = rng.prng_key(6)
    cases = {"B=1": 1, "B=31": 31, "B=37": 37, "several refills": 4 * blocks * 128 + 5,
             "all inactive": 4096, "scattered": 65536}
    for seed, (name, B) in enumerate(cases.items()):
        g = np.random.default_rng(seed)
        o = (g.uniform(-3, 3, (B, 3)) * [1, 0.5, 1] + [0, 2.5, 0]).astype(np.float32)
        d = g.normal(size=(B, 3)).astype(np.float32)
        d[:8, 0] = 0.0  # the slab test's NaN terms
        o[:4, 0] = 0.0
        o, d = (torch.from_numpy(x).to(dev) for x in (o, d))
        if name == "scattered":
            active = torch.from_numpy(g.uniform(size=B) < 0.1).to(dev)
        else:
            active = torch.arange(B, device=dev) % 13 != 5
        if name == "all inactive":
            active[:] = False
        ov, dv = Vec3(*o.unbind(1)), Vec3(*d.unbind(1))
        kout = pw.closest_bvh(scene, ov, dv, active)
        pout = pw.closest_bvh_plain(scene, ov, dv, active)
        check(all(torch.equal(k, p_) for k, p_ in zip(kout[:4], pout[:4])),
              f"closest_bvh {name}: t, tri, u or v differ from the plain version's")
        check(kout[4].tolist() == pout[4].tolist(), f"closest_bvh {name}: counters differ")
        state = torch.zeros((pw.STATE_ROWS, B), device=dev)
        state[pw.OX:pw.DX + 3] = torch.cat([o.T, d.T])
        state[pw.THR:pw.THR + 3] = 0.5
        state[pw.RAD:pw.RAD + 3] = 0.25
        state[pw.ALIVE] = active.float()
        rid = torch.arange(B, dtype=torch.int32, device=dev)
        live = active.nonzero()[:, 0]
        fracs = []
        for hits in (None, kout[:2]):
            got, gc = pw.pt_wave_bounce(scene, state, rid, key, 2, hits)
            want, wc = pw.pt_wave_bounce_plain(scene, state, rid, key, 2, hits)
            packed = pw.pt_wave_bounce(scene, state[:, live].contiguous(), rid[live], key, 2,
                                       None if hits is None else tuple(h[live] for h in hits))[0]
            mode = "paged" if hits else "walk"
            check(gc.tolist() == wc.tolist(), f"pt_wave_bounce {mode} {name}: counters differ")
            check(torch.equal(got[:pw.ALIVE, ~active], state[:pw.ALIVE, ~active])
                  and not bool(got[pw.ALIVE, ~active].any()),
                  f"pt_wave_bounce {mode} {name}: a dead lane's rows changed")
            check(torch.equal(got[:, live], packed),
                  f"pt_wave_bounce {mode} {name}: a live lane differs from its packed launch")
            keep = want[pw.ALIVE] > 0.5
            rows, prows = (torch.cat([torch.where(keep, x[:pw.RAD], 0.0), x[pw.RAD:]]).T
                           for x in (got, want))
            f, e, worst = agreement(rows, prows) if B else (1.0, 0.0, 0)
            check(f >= MIN_FRAC, f"pt_wave_bounce {mode} {name}: only {f:.5f} of lanes agree")
            fracs.append(f)
        print(f"phase 22: {name} (B={B}, {live.numel()} live): closest_bvh equals its plain "
              f"version to the bit, counters {kout[4].tolist()}; pt_wave_bounce walk / paged: "
              f"counters equal, dead lanes copied, live lanes equal to their packed launch, "
              f"{fracs[0] * 100:.4f}% / {fracs[1] * 100:.4f}% within rtol {RTOL} / atol {ATOL} "
              f"of the plain version ({card})")
    print(f"phase 22: closest_bvh's persistent grid (pt_wave_bounce's walk too): {blocks} "
          f"blocks of 128 threads ({card})")
    return {"blocks": blocks, "cases": list(cases)}


def mixed_scene(dev):
    """tests/torch_parity.py::mixed_scene: the cornell box with a fuzzy
    metal quad, a glass box and an isotropic quad (every material type)."""
    from bpt_tpu_torch.scene.builder import MaterialSpec as MS
    from bpt_tpu_torch.scene.presets import cornell_box_builder

    mb = cornell_box_builder()
    mb.add_quad((60, 20, 60), (150, 0, 0), (0, 150, 40), MS.metal((0.8, 0.85, 0.9), 0.3))
    mb.add_box((340, 0, 80), (460, 120, 200), MS.dielectric(1.5))
    mb.add_quad((100, 400, 400), (120, 0, 0), (0, 0, 100), MS.isotropic((0.6, 0.7, 0.5)))
    return mb.build(device=dev)


def cornell_lanes(cc, name, B, seed, dev):
    """(o, d, ids) of a brute-force edge case: the cornell camera's rays
    through random points of a 512x512 image (``cc``), one lane in 13
    inactive; "scattered": one live lane in ten at random places; "all
    inactive": none live."""
    import numpy as np
    import torch

    from bpt_tpu_torch.core.vec3 import Vec3
    from bpt_tpu_torch.models.camera import generate_rays

    g = np.random.default_rng(seed)
    px = torch.from_numpy(g.integers(0, 512, (2, B)).astype(np.float32)).to(dev)
    u = torch.from_numpy(g.uniform(size=(B, 4)).astype(np.float32)).to(dev)
    o, d = generate_rays(cc, px[0], px[1], px[0] * 0, px[1] * 0, u)
    ids = torch.arange(B, dtype=torch.int32, device=dev)
    if name == "scattered":
        ids = torch.where(torch.from_numpy(g.uniform(size=B) < 0.1).to(dev), ids, -1)
    else:
        ids[5::13] = -1
    if name == "all inactive":
        ids[:] = -1
    return Vec3(*o.unbind(1)), Vec3(*d.unbind(1)), ids


def held(name, kout, pout, launched, want_launches, atol):
    """Checks a brute-force edge case against its plain version: the
    launches, >= 99.9% of lanes within rtol 1e-4 / ``atol``, every counter
    exact.  Returns (fraction within tolerance, max abs err, counters)."""
    import torch

    got, want = (torch.stack(x[:3], 1) for x in (kout, pout))
    f, e, _ = agreement(got, want, atol) if got.shape[0] else (1.0, 0.0, 0)
    kc, pc = counters(kout), counters(pout)
    check(launched == want_launches, f"{name}: {launched} launches, not {want_launches}")
    check(f >= MIN_FRAC, f"{name}: only {f:.5f} of lanes agree with the plain version")
    check(kc == pc, f"{name}: counters kernel {kc} plain {pc}")
    return f, e, kc


def packed_equal(what, mk, kout, a, ids, kw):
    """Checks that an edge case's inactive lanes are 0 and its live lanes
    equal to the bit to the same lanes launched alone, packed (rays mode:
    ``a`` = (scene, o, d, ids, ...))."""
    import torch

    from bpt_tpu_torch.core.vec3 import Vec3

    live = ids >= 0
    scene, o, d, _, *rest = a
    packed = mk(scene, Vec3(*(x[live] for x in o)), Vec3(*(x[live] for x in d)), ids[live],
                *rest, **kw)
    check(all(float(c[~live].abs().sum()) == 0.0 for c in kout[:3]),
          f"{what}: an inactive lane has radiance")
    check(all(torch.equal(c[live], pc) for c, pc in zip(kout[:3], packed[:3]))
          and counters(packed) == counters(kout), f"{what}: differs from its live lanes packed")


def brute_pt_cases(dev, card) -> dict:
    """The brute-force PT kernel on its persistent grid, whose lanes run a
    flat bounce loop, against its plain version: rays mode at depth 10 on
    the cornell camera's rays (cornell_lanes), B = 1, 31 and 37, 4 x the
    persistent grid's threads and 5 more, every lane inactive, one live
    lane in ten scattered among 4096: radiance within rtol 1e-4 / atol
    1e-6 on >= 99.9% of lanes, all five counters exact, inactive lanes 0,
    live lanes equal to the bit to the same lanes launched alone, packed.
    Then pixels mode at depth 1 (cornell, 16x16 x 4 spp) and 80 (the mixed
    scene), pixels mode with spp_loop 1 (each stratum a lane), rays mode
    with injected uniforms, and pixels mode over 4 stratum ranges
    (pt_kernel.STRATA_BYTES patched to one stratum a launch): the same
    tolerance, counters exact."""
    import numpy as np
    import torch

    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.models.camera import camera_constants
    from bpt_tpu_torch.models.pt import NU
    from bpt_tpu_torch.ops.kernels import build
    from bpt_tpu_torch.ops.kernels import pt_kernel as pk
    from bpt_tpu_torch.scene.presets import cornell_box, cornell_box_camera

    lib = build.load_library()
    with torch.cuda.device(dev):
        blocks = lib.bpt_pt_blocks(0, 0)
    check(blocks > 0, f"pt_megakernel's occupancy query failed: CUDA error {-blocks}")
    cornell, mixed = cornell_box(device=dev), mixed_scene(dev)
    cc = camera_constants(dataclasses.replace(cornell_box_camera(), image_width=512),
                          torch.float32, dev)
    key = rng.prng_key(17)
    cases = {"B=1": 1, "B=31": 31, "B=37": 37, "past 4 grids": 4 * blocks * 128 + 5,
             "all inactive": 4096, "scattered": 4096}
    worst = 0.0
    for seed, (name, B) in enumerate(cases.items()):
        t0 = time.monotonic()
        o, d, ids = cornell_lanes(cc, name, B, 20 + seed, dev)
        a = (cornell, o, d, ids, key, 10)
        n = pk.pt_megakernel.launches
        kout = pk.pt_megakernel(*a)
        launched = pk.pt_megakernel.launches - n
        pout = pk.pt_megakernel_plain(*a)
        what = f"pt_megakernel {name} (B={B})"
        f, e, kc = held(what, kout, pout, launched, 1, ATOL)
        packed_equal(what, pk.pt_megakernel, kout, a, ids, {})
        worst = max(worst, e)
        print(f"phase 22: {what}, {int((ids >= 0).sum())} live: {f * 100:.4f}% of lanes "
              f"within rtol {RTOL} / atol {ATOL}, max abs err {e:.3e}; counters {kc} exact; "
              f"live lanes equal to their packed launch; {time.monotonic() - t0:.1f} s ({card})")
    modes = ("depth 1", "depth 80", "spp_loop 1", "injected", "ranges")
    for name in modes:
        t0 = time.monotonic()
        want_launches = 1
        if name == "injected":
            o, d, ids = cornell_lanes(cc, name, 4096, 29, dev)
            u = torch.from_numpy(np.random.default_rng(30).uniform(
                size=(10 * NU, 4096)).astype(np.float32)).to(dev)
            a, kw = (cornell, o, d, ids, key, 10), dict(uniforms=u)
            mk, plain = pk.pt_megakernel, pk.pt_megakernel_plain
        else:
            W, S = 16, 2
            depth = {"depth 1": 1, "depth 80": 80}.get(name, 10)
            cc16 = camera_constants(dataclasses.replace(
                cornell_box_camera(), image_width=W, samples_per_pixel=S * S), torch.float32, dev)
            pix = torch.arange(W * W, dtype=torch.int32, device=dev)
            if name == "spp_loop 1":  # each stratum a lane, its absolute sample id
                st = torch.arange(S * S, dtype=torch.int32, device=dev).repeat_interleave(W * W)
                pix = pix.repeat(S * S)
                ids = pix * (S * S) + st
                ids[3::7] = -1
                i, j = (pix % W).float(), (pix // W).float()
                sx, sy = (st % S).float(), (st // S).float()
                kw = dict(spp_loop=1, sqrt_spp=S)
            else:
                ids = pix.clone()
                ids[3::7] = -1
                i, j = (pix % W).float(), (pix // W).float()
                sx, sy = i * 0, j * 0
                kw = dict(spp_loop=S * S, sqrt_spp=S)
            a = (mixed if name == "depth 80" else cornell, i, j, sx, sy, ids,
                 pk.camera_table(cc16), key, depth)
            mk, plain = pk.pt_megakernel_pixels, pk.pt_megakernel_pixels_plain
        with contextlib.ExitStack() as stack:
            if name == "ranges":
                budget = pk.STRATA_BYTES
                pk.STRATA_BYTES = 12 * ids.numel()
                stack.callback(setattr, pk, "STRATA_BYTES", budget)
                want_launches = kw["spp_loop"]
            n = mk.launches
            kout = mk(*a, **kw)
            launched = mk.launches - n
        pout = plain(*a, **kw)
        what = f"{mk.__name__} {name}"
        f, e, kc = held(what, kout, pout, launched, want_launches, ATOL)
        worst = max(worst, e)
        print(f"phase 22: {what}: {launched} launch(es), {f * 100:.4f}% of lanes within rtol "
              f"{RTOL} / atol {ATOL}, max abs err {e:.3e}; counters {kc} exact; "
              f"{time.monotonic() - t0:.1f} s ({card})")
    print(f"phase 22: pt_megakernel's persistent grid: {blocks} blocks of 128 threads ({card})")
    return {"blocks": blocks, "max_abs_err": worst,
            "cases": list(cases) + list(modes)}


def brute_bdpt_cases(dev, card) -> dict:
    """The brute-force BDPT kernel on its persistent grid against its plain
    version, bdpt and bdpt-mis: rays mode at depth 10 on the cornell
    camera's rays (cornell_lanes), B = 1, 31 and
    37, 4 x the persistent grid's threads and 5 more, every lane inactive,
    one live lane in ten scattered among 4096 (else one in 13 inactive):
    radiance within rtol 1e-4 / atol 1e-5 on >= 99.9% of lanes, all six
    counters exact, inactive lanes 0, live lanes equal to the bit to the
    same lanes launched alone, packed.  Then pixels mode at depth 1
    (cornell, 16x16 x 4 spp) and 80 (the mixed scene, 32x32 x 1 spp), rays
    mode with injected uniforms, and pixels mode over 4 stratum ranges
    (pt_kernel.STRATA_BYTES patched to one stratum a launch): the same
    tolerance, counters exact."""
    import numpy as np
    import torch

    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.models.camera import camera_constants
    from bpt_tpu_torch.ops.kernels import bdpt_kernel as bk
    from bpt_tpu_torch.ops.kernels import build
    from bpt_tpu_torch.ops.kernels import pt_kernel as pk
    from bpt_tpu_torch.scene.presets import cornell_box, cornell_box_camera

    lib = build.load_library()
    with torch.cuda.device(dev):
        blocks = lib.bpt_bdpt_blocks(0, 0)
    check(blocks > 0, f"bdpt_megakernel's occupancy query failed: CUDA error {-blocks}")
    cornell, mixed = cornell_box(device=dev), mixed_scene(dev)
    cc = camera_constants(dataclasses.replace(cornell_box_camera(), image_width=512),
                          torch.float32, dev)
    key = rng.prng_key(7)

    cases = {"B=1": 1, "B=31": 31, "B=37": 37, "past 4 grids": 4 * blocks * 128 + 5,
             "all inactive": 4096, "scattered": 4096}
    worst = 0.0
    for seed, (name, B) in enumerate(cases.items()):
        o, d, ids = cornell_lanes(cc, name, B, seed, dev)
        live = ids >= 0
        for mis in (False, True):
            t0 = time.monotonic()
            n = bk.bdpt_megakernel.launches
            a = (cornell, o, d, ids, key, 10)
            kout = bk.bdpt_megakernel(*a, mis=mis)
            launched = bk.bdpt_megakernel.launches - n
            pout = bk.bdpt_megakernel_plain(*a, mis=mis)
            what = f"bdpt_megakernel {'bdpt-mis' if mis else 'bdpt'} {name} (B={B})"
            f, e, kc = held(what, kout, pout, launched, 1, BDPT_ATOL)
            packed_equal(what, bk.bdpt_megakernel, kout, a, ids, dict(mis=mis))
            worst = max(worst, e)
            print(f"phase 22: {what}, {int(live.sum())} live: {f * 100:.4f}% of lanes within "
                  f"rtol {RTOL} / atol {BDPT_ATOL}, max abs err {e:.3e}; counters {kc} exact; "
                  f"live lanes equal to their packed launch; {time.monotonic() - t0:.1f} s "
                  f"({card})")
    for name in ("depth 1", "depth 80", "injected", "ranges"):
        for mis in (False, True):
            t0 = time.monotonic()
            with contextlib.ExitStack() as stack:
                if name == "injected":
                    o, d, ids = cornell_lanes(cc, name, 4096, 9, dev)
                    u = torch.from_numpy(np.random.default_rng(10).uniform(
                        size=(bk.n_uniform_slots(10), 4096)).astype(np.float32)).to(dev)
                    a, kw = (cornell, o, d, ids, key, 10), dict(uniforms=u, mis=mis)
                    mk, plain, want_launches = bk.bdpt_megakernel, bk.bdpt_megakernel_plain, 1
                else:
                    # depth 80 at 1 spp: the plain version runs a pixel's
                    # strata one after another, each a wave of 80 bounces
                    W, S = (32, 1) if name == "depth 80" else (16, 2)
                    depth = {"depth 1": 1, "depth 80": 80}.get(name, 10)
                    cc16 = camera_constants(dataclasses.replace(
                        cornell_box_camera(), image_width=W, samples_per_pixel=S * S),
                        torch.float32, dev)
                    pix = torch.arange(W * W, dtype=torch.int32, device=dev)
                    pix[3::7] = -1
                    i, j = (pix.clamp_min(0) % W).float(), (pix.clamp_min(0) // W).float()
                    want_launches = 1
                    if name == "ranges":
                        budget = pk.STRATA_BYTES
                        pk.STRATA_BYTES = 12 * W * W
                        stack.callback(setattr, pk, "STRATA_BYTES", budget)
                        want_launches = S * S
                    a = (mixed if name == "depth 80" else cornell, i, j, pix,
                         pk.camera_table(cc16), key, depth, S)
                    kw = dict(mis=mis)
                    mk, plain = bk.bdpt_megakernel_pixels, bk.bdpt_megakernel_pixels_plain
                n = mk.launches
                kout = mk(*a, **kw)
                launched = mk.launches - n
                pout = plain(*a, **kw)
            what = f"{mk.__name__} {'bdpt-mis' if mis else 'bdpt'} {name}"
            f, e, kc = held(what, kout, pout, launched, want_launches, BDPT_ATOL)
            worst = max(worst, e)
            print(f"phase 22: {what}: {launched} launch(es), {f * 100:.4f}% of lanes within "
                  f"rtol {RTOL} / atol {BDPT_ATOL}, max abs err {e:.3e}; counters {kc} exact; "
                  f"{time.monotonic() - t0:.1f} s ({card})")
    print(f"phase 22: bdpt_megakernel's persistent grid: {blocks} blocks of 128 threads ({card})")
    return {"blocks": blocks, "max_abs_err": worst,
            "cases": list(cases) + ["depth 1", "depth 80", "injected", "ranges"]}


def defocus_wave_vs_plain(name, args, kw, stride=16):
    """A cornell defocus wave's launch (rays mode; ``name`` pt or bdpt,
    ``args``, ``kw`` as the render made them) against its plain version.
    The plain version holds every lane's state at once, too much for all
    4,194,304 lanes, so it runs on every ``stride``-th lane
    (``sliced_vs_plain``): rtol 1e-4 / atol 1e-6 (PT) or 1e-5 (BDPT) on
    >= 99.9% of lanes, every counter exact.  Returns (the whole launch's
    outputs, fraction within tolerance, max abs err, plain ms, lanes
    compared)."""
    from bpt_tpu_torch.ops.kernels import bdpt_kernel as bk
    from bpt_tpu_torch.ops.kernels import pt_kernel as pk

    mod = pk if name == "pt" else bk
    mk, plain = getattr(mod, f"{name}_megakernel"), getattr(mod, f"{name}_megakernel_plain")
    return sliced_vs_plain(f"phase 13: {mk.__name__} on the defocus {name} wave", mk, plain,
                           args, kw, stride, ATOL if name == "pt" else BDPT_ATOL)


def any_cases(dev, card) -> dict:
    """any_bvh on its refilling grid against its plain version on the
    964-triangle scene: B = 1, 31 and 37 (one lane in five dead), 65,536
    dead lanes, one live lane among 1,048,576 dead ones (held against the
    plain walk of that lane), 65,536 live lanes: every answer and the four
    counters equal, every dead lane a miss."""
    import numpy as np
    import torch

    from bpt_tpu_torch.core.vec3 import Vec3
    from bpt_tpu_torch.ops.kernels import build
    from bpt_tpu_torch.ops.kernels import pt_wave as pw

    scene = big_scene(dev)
    lib = build.load_library()
    with torch.cuda.device(dev):
        blocks = lib.bpt_any_blocks()
    check(blocks > 0, f"any_bvh's occupancy query failed: CUDA error {-blocks}")
    cases = {"B=1": 1, "B=31": 31, "B=37": 37, "all dead": 65536, "one live lane": 1 << 20,
             "all live": 65536}
    for seed, (name, B) in enumerate(cases.items()):
        t0 = time.monotonic()
        g = np.random.default_rng(40 + seed)
        o = (g.uniform(-3, 3, (B, 3)) * [1, 0.5, 1] + [0, 2.5, 0]).astype(np.float32)
        d = g.normal(size=(B, 3)).astype(np.float32)
        tmax = g.uniform(0.1, 6.0, B).astype(np.float32)
        at = int(g.integers(0, B))
        if name == "all dead":
            tmax[:] = 0.0
        elif name == "one live lane":
            tmax[np.arange(B) != at] = -1.0
        elif name != "all live":
            tmax[2::5] = 0.0
        o, d, tmax = (torch.from_numpy(x).to(dev) for x in (o, d, tmax))
        ov, dv = Vec3(*o.unbind(1)), Vec3(*d.unbind(1))
        hit, c = pw.any_bvh(scene, ov, dv, tmax)
        live = tmax > 0
        if name == "one live lane":
            sel = torch.tensor([at], device=dev)
            want, wc = pw.any_bvh_plain(scene, Vec3(*(x[sel] for x in ov)),
                                        Vec3(*(x[sel] for x in dv)), tmax[sel])
            same = bool(hit[at]) == bool(want[0])
        else:
            want, wc = pw.any_bvh_plain(scene, ov, dv, tmax)
            same = torch.equal(hit, want)
        check(same and c.tolist() == wc.tolist() and not bool(hit[~live].any()),
              f"any_bvh {name}: answers or counters {c.tolist()} differ from the plain "
              f"version's {wc.tolist()}")
        print(f"phase 22: any_bvh {name} (B={B}, {int(live.sum())} live, {int(hit.sum())} "
              f"hits): answers and counters {c.tolist()} equal to the plain version's; "
              f"{time.monotonic() - t0:.1f} s ({card})")
    print(f"phase 22: any_bvh's persistent grid: {blocks} blocks of 128 threads ({card})")
    return {"blocks": blocks, "cases": list(cases)}


def textured_coffee(scene):
    """bench.py's coffee_91k_tex_pt scene (bench.py:60-81): the coffee
    stand-in with a checker of scale 0.02 on its first lambertian."""
    import torch

    from bpt_tpu_torch.scene.textures import TextureSpec, build_texture_table
    from bpt_tpu_torch.scene.types import MAT_LAMBERTIAN

    tt = build_texture_table([TextureSpec.checker(0.02, (0.9, 0.4, 0.05), (0.1, 0.1, 0.1))],
                             device=scene.device)
    mats = scene.materials
    tex_id = mats.tex_id.clone()
    tex_id[int(torch.nonzero(mats.mtype == MAT_LAMBERTIAN)[0, 0])] = 0
    return dataclasses.replace(scene, materials=dataclasses.replace(mats, tex_id=tex_id),
                               textures=tt, has_textures=True)


def textured_small(dev):
    """A textured scene of 40 triangles, without a BVH: a checker sphere
    on a noise floor under a checker light at y = 6.03, off its cells'
    boundaries (tests/torch_parity.py::textured_wave_scene, light=True,
    with the floor textured)."""
    from bpt_tpu_torch.scene.builder import MaterialSpec as MS, SceneBuilder
    from bpt_tpu_torch.scene.textures import TextureSpec as TS

    b = SceneBuilder()
    b.add_uv_sphere((0, 1, 0), 1.0, MS.lambertian(
        texture=TS.checker(0.35, (0.9, 0.3, 0.2), (0.1, 0.8, 0.3))), lat_steps=4, lon_steps=6)
    b.add_quad((-10, 0, -10), (20, 0, 0), (0, 0, 20), MS.lambertian(texture=TS.noise(3.0)))
    b.add_quad((-2, 6.03, -2), (4, 0, 0), (0, 0, 4), MS.diffuse_light(
        (1, 1, 1), texture=TS.checker(0.5, (12.0, 10.0, 4.0), (2.0, 2.0, 10.0))))
    return b.build(device=dev)


def state_rows_agree(name, kout, pout, hit):
    """(fraction of lanes within tolerance, max abs err) of two wave
    states: the origin rows on every lane (the hit point on a lane that hit,
    whether it lives on or not), direction and throughput on the lanes the
    plain version keeps alive, radiance and alive on every lane."""
    import torch

    from bpt_tpu_torch.ops.kernels import pt_wave as pw

    live = pout[pw.ALIVE] > 0.5
    rows, prows = (torch.cat([x[:pw.DX], torch.where(live, x[pw.DX:pw.RAD], 0.0),
                              x[pw.RAD:]]).T for x in (kout, pout))
    f, e, worst = agreement(rows, prows)
    check(bool(hit.any()) and bool(live.any()), f"{name}: no lane hits or stays alive")
    check(f >= MIN_FRAC, f"{name}: only {f:.5f} of lanes agree; worst lane {worst}: kernel "
          f"{rows[worst].tolist()} plain {prows[worst].tolist()}")
    return f, e


# phase 23's shapes: kernel 9's textured mode against its plain version
# (rays, depth); the textured coffee render (width, spp, depth); earth.yaml's
# PT render at its own size and BDPT-MIS (width, spp, depth)
TEX_WAVE = (65536, 3)
TEX_COFFEE = (512, 4, 10)
EARTH_RENDERS = {"pt": (512, 64, 8), "bdpt-mis": (256, 4, 8)}


def texture_phases(dev, card, coffee, ccc, key, scene_bytes, lap) -> dict:
    """Phase 23, textures: (a) image lookups on the card against the CPU;
    (b) pt_wave's textured mode against pt_wave_plain on the textured
    coffee stand-in (closest_bvh's hits) and a textured scene of 40
    triangles (closest_tri's), and one launch at the textured coffee
    render's first bounce on every 16th lane; (c) the textured coffee PT
    render (bench.py's coffee_91k_tex_pt); (d) scenes/earth.yaml through
    render(), PT and BDPT-MIS.  Returns the numbers of kernel 9's textured
    mode for the kernels line."""
    import importlib.util

    import numpy as np
    import torch

    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.core.vec3 import Vec3
    from bpt_tpu_torch.models.render import _route, render
    from bpt_tpu_torch.ops import soa
    from bpt_tpu_torch.ops.kernels import bdpt_kernel as bk
    from bpt_tpu_torch.ops.kernels import intersect as ki
    from bpt_tpu_torch.ops.kernels import pt_kernel as pk
    from bpt_tpu_torch.ops.kernels import pt_wave as pw
    from bpt_tpu_torch.scene.loader import load_scene_from_yaml
    from bpt_tpu_torch.scene.textures import TextureSpec as TS
    from bpt_tpu_torch.scene.textures import build_texture_table, texture_value
    from bpt_tpu_torch.scene.types import TEX_NOISE, TextureTable
    from bpt_tpu_torch.utils.png import write_png

    out = {}
    kernels = (pw.closest_bvh, pw.any_bvh, pw.pt_wave_bounce, ki.closest_tri, ki.any_tri,
               pk.pt_megakernel, pk.pt_megakernel_pixels, bk.bdpt_megakernel,
               bk.bdpt_megakernel_pixels)
    plains = (pk.pt_megakernel_plain, pk.pt_megakernel_pixels_plain, pk.strata_sum_plain,
              bk.bdpt_megakernel_plain, bk.bdpt_megakernel_pixels_plain,
              pw.closest_bvh_plain, pw.any_bvh_plain, pw.pt_wave_bounce_plain,
              pw.pt_wave_plain, ki.closest_tri_plain, ki.any_tri_plain, soa.bvh_closest,
              soa.bvh_any)

    def zero_counts():
        for fn in kernels:
            fn.launches = 0
        for fn in plains:
            fn.calls = 0

    def read_counts():
        return ({fn.__name__: fn.launches for fn in kernels if fn.launches},
                sum(fn.calls for fn in plains))

    # ---- (a) image lookups on the card
    has_pil = importlib.util.find_spec("PIL") is not None
    g = np.random.default_rng(23)
    tt = build_texture_table([TS.image("seeded"), TS.checker(0.35, (0.9, 0.3, 0.2),
                                                             (0.1, 0.8, 0.3)),
                              TS.noise(4.0), TS.solid((0.2, 0.4, 0.6))], device="cpu")
    atlas = torch.from_numpy(g.integers(0, 256, (1, 37, 53, 3)).astype(np.float32))
    tt = dataclasses.replace(tt, images=atlas, img_h=torch.tensor([37]),
                             img_w=torch.tensor([53]))
    tt_card = TextureTable(**{f.name: getattr(tt, f.name).to(dev)
                              for f in dataclasses.fields(tt)})
    N = 1 << 20
    tid = torch.from_numpy(g.integers(0, 4, N))
    u, v = (torch.from_numpy(g.uniform(-0.1, 1.1, N).astype(np.float32)) for _ in range(2))
    p = torch.from_numpy(g.uniform(-5, 5, (N, 3)).astype(np.float32))
    want = texture_value(tt, tid, u, v, p)
    args = [x.to(dev) for x in (tid, u, v, p)]
    got, tex_ms = timed(lambda: texture_value(tt_card, *args))
    got = got.cpu()
    noise = (tt.kind[tid] == TEX_NOISE)[:, None]
    exact = bool(torch.equal(torch.where(noise, 0.0, got), torch.where(noise, 0.0, want)))
    noise_err = float(((got - want).abs() * noise).max())
    check(exact, "texture_value on the card differs from the CPU's on an image, checker "
                 "or solid lane")
    check(noise_err <= 1e-5, f"texture_value's noise on the card {noise_err:.3e} from the CPU's")
    print(f"phase 23a: Pillow {'present' if has_pil else 'absent (images load as the magenta fallback)'}; "
          f"texture_value on {N} card lanes (a seeded 37x53 atlas, checker, noise, solid) "
          f"equal to the CPU's on every image, checker and solid lane, noise within "
          f"{noise_err:.3e}; {tex_ms:.3f} ms on the card ({card})")
    del got, want, args
    lap("phase 23a")

    # ---- (b) kernel 9's textured mode against its plain version
    tex_coffee = textured_coffee(coffee)
    small = textured_small(dev)
    check(not small.use_bvh and small.has_textures and small.has_noise,
          "the small textured scene has a BVH or no textures")
    key_pt = rng.fold_in(key, 1)
    B, depth_w = TEX_WAVE
    o_c, d_c, ids_c = wave_rays(ccc, torch.arange(B, device=dev) * (ccc.width ** 2 // B), 1,
                                key, dev)
    o_s = torch.tensor([0.0, 2.0, 6.0], device=dev).expand(B, 3)
    tgt = torch.from_numpy(np.c_[g.uniform(-3, 3, B), g.uniform(0, 7, B),
                                 np.zeros(B)].astype(np.float32)).to(dev)
    cases = (("coffee (BVH: closest_bvh)", tex_coffee, o_c, d_c, ids_c, pw.closest_bvh),
             ("40 triangles (no BVH: closest_tri)", small, Vec3(*o_s.unbind(1)),
              Vec3(*(tgt - o_s).unbind(1)), torch.arange(B, dtype=torch.int32, device=dev),
              ki.closest_tri))
    tw_frac, tw_err = 1.0, 0.0
    for name, sc, o_, d_, ids_, hit_kernel in cases:
        zero_counts()
        kout = pw.pt_wave(sc, o_, d_, ids_, key_pt, depth_w)
        torch.cuda.synchronize()
        launched, n_plain = read_counts()
        check(launched == {hit_kernel.__name__: depth_w, "pt_wave_bounce": depth_w}
              and not n_plain, f"textured pt_wave {name}: launches {launched}, plain {n_plain}")
        pout, p_ms = timed(lambda: pw.pt_wave_plain(sc, o_, d_, ids_, key_pt, depth_w))
        f, e = compare(f"phase 23b: textured pt_wave on {name}, B={B} depth={depth_w}", kout,
                       pout, exact_counts=True)
        check(float(torch.stack(kout[:3]).sum()) > 0, f"textured pt_wave {name}: black")
        k_ms = time_ms(lambda: pw.pt_wave(sc, o_, d_, ids_, key_pt, depth_w), reps=5)
        print(f"phase 23b: textured pt_wave on {name}: kernel {k_ms:.3f} ms, plain "
              f"{p_ms:.3f} ms (one call) ({card})")
        tw_frac, tw_err = min(tw_frac, f), max(tw_err, e)
        if sc is small:
            out["brute_wave_ms"], out["brute_wave_plain_ms"] = k_ms, p_ms
            out["brute_wave_closest_tri_launches"] = launched.get("closest_tri", 0)
    del kout, pout
    lap("phase 23b")

    # ---- (c) the textured coffee PT render: bench.py's coffee_91k_tex_pt
    width, spp, depth = TEX_COFFEE
    cfg = dataclasses.replace(coffee_camera(width, spp, depth),
                              file_name="chip_smoke_coffee_tex_pt.png")
    check(_route(tex_coffee, cfg, "pt", None) == "wave", "textured coffee PT is not routed to pt_wave")
    with capture(pw, "pt_wave_bounce") as bounces:  # the warm-up records its launches
        render(tex_coffee, cfg, seed=0)
    check(len(bounces) == cfg.max_depth, f"textured coffee: {len(bounces)} shade launches")
    zero_counts()
    results = [render(tex_coffee, cfg, seed=0) for _ in range(3)]
    launched, n_plain = read_counts()
    check(set(launched) == {"closest_bvh", "pt_wave_bounce"} and not n_plain,
          f"textured coffee PT launched {launched}, plain calls {n_plain}")
    check(launched.get("closest_bvh") == launched.get("pt_wave_bounce") == 3 * cfg.max_depth,
          f"textured coffee PT launches {launched}")
    walls = [r.stats.wall_seconds for r in results]
    wall = statistics.median(walls)
    st = results[0].stats
    fb = results[0].framebuffer_sum
    check(bool(np.isfinite(fb).all()) and float(fb.mean()) > 0.0,
          "textured coffee: non-finite or black image")
    check(all(np.array_equal(r.framebuffer_sum, fb) for r in results[1:]),
          "textured coffee: renders with the same seed differ")
    plain_render = render(coffee, cfg, seed=0)
    gap = st.rays_traced - plain_render.stats.rays_traced
    path = write_png(cfg.file_name, results[0].rgb8(), output_dir="output")
    # each bounce of the warm-up on its own inputs: walk + shade, the shade
    # alone on the walk's hits, and the texel stage after it
    rows = []
    for a, kw in bounces.values():
        sc, state, rid, k_, b_ = a[:5]
        o_, d_, alive = Vec3(*state[pw.OX:pw.OX + 3]), Vec3(*state[pw.DX:pw.DX + 3]), \
            state[pw.ALIVE] > 0.5
        walk_ms = time_ms(lambda: pw.closest_bvh(sc, o_, d_, alive), reps=3)
        t, tri, hu, hv, walk = pw.closest_bvh(sc, o_, d_, alive)
        shade_ms = time_ms(lambda: pw.pt_wave_bounce(sc, state, rid, k_, b_, (t, tri), **kw),
                           reps=3)
        nxt, c = pw.pt_wave_bounce(sc, state, rid, k_, b_, (t, tri), **kw)
        stage_ms = time_ms(lambda: pw.texel_stage(sc, nxt, tri, hu, hv), reps=3)
        rows.append(dict(live=int(alive.sum()), ms=walk_ms + shade_ms, shade_ms=shade_ms,
                         texel_stage_ms=stage_ms,
                         bound=bound(int(alive.shape[0]) * (2 * pw.STATE_ROWS * 4 + 4)
                                     + scene_bytes,
                                     int(walk[0]) * SLAB_OPS + int(walk[2]) * MT_OPS)[0]))
    render_ms = sum(r["ms"] for r in rows)
    stage_sum = sum(r["texel_stage_ms"] for r in rows)
    # the first bounce against its plain version, every 16th lane
    (sc, state, rid, k_, _, _), kw = bounces[0]
    t, tri, hu, hv, _ = pw.closest_bvh(sc, Vec3(*state[pw.OX:pw.OX + 3]),
                                       Vec3(*state[pw.DX:pw.DX + 3]), state[pw.ALIVE] > 0.5)
    sl = slice(None, None, 16)
    st_s, rid_s, hits_s = state[:, sl].contiguous(), rid[sl].contiguous(), \
        (t[sl].contiguous(), tri[sl].contiguous())
    kb, kc = pw.pt_wave_bounce(sc, st_s, rid_s, k_, 0, hits_s)
    pw.texel_stage(sc, kb, tri[sl], hu[sl], hv[sl])
    (pb, pc), b_plain_ms = timed(lambda: pw.pt_wave_bounce_plain(sc, st_s, rid_s, k_, 0,
                                                                 hits_s))
    pw.texel_stage(sc, pb, tri[sl], hu[sl], hv[sl])
    f, e = state_rows_agree("textured wave kernel at bounce 0", kb, pb, tri[sl] >= 0)
    check(kc.tolist() == pc.tolist(), f"textured bounce 0: counters {kc.tolist()} vs "
                                      f"{pc.tolist()}")
    tw_frac, tw_err = min(tw_frac, f), max(tw_err, e)
    _, b_plain_full_ms = timed(lambda: pw.pt_wave_bounce_plain(sc, state, rid, k_, 0,
                                                               (t, tri)))
    B0 = int(state.shape[1])
    print(f"phase 23c: render textured coffee {width}x{width} {spp} spp depth {depth} seed 0: walls "
          f"{[round(w, 6) for w in walls]} s, median {wall:.6f} s, "
          f"{st.rays_traced / wall / 1e6:.3f} Mrays/s; rays_traced {st.rays_traced}, the same "
          f"render untextured {plain_render.stats.rays_traced} "
          f"({'equal' if gap == 0 else f'{gap:+d}'}: textures change throughput only); "
          f"launches {launched}, plain calls {n_plain}; texel stage {stage_sum:.3f} ms of the "
          f"{len(rows)} bounces ({stage_sum / len(rows):.3f} ms a bounce, "
          f"{stage_sum / 1e3 / wall * 100:.2f}% of the wall); wrote {path} ({card})")
    print(f"phase 23c: the wave kernel at the textured render's first bounce (B={B0}): walk "
          f"+ shade {rows[0]['ms']:.3f} ms, the shade alone {rows[0]['shade_ms']:.3f} ms, "
          f"texel stage {rows[0]['texel_stage_ms']:.3f} ms, plain {b_plain_full_ms:.3f} ms "
          f"(one call, the shade on the same hits), bound {rows[0]['bound']:.4f} ms; on every "
          f"16th lane ({st_s.shape[1]}) with the texel stage: {f * 100:.4f}% of lanes within "
          f"rtol {RTOL} / atol {ATOL} (origin rows on every lane), max abs err {e:.3e}, "
          f"counters {kc.tolist()} ({card})")
    per_bounce = ", ".join("{live}: {ms:.3f} (+{texel_stage_ms:.3f})".format(**r) for r in rows)
    print(f"phase 23c: walk + shade (+ texel stage), the {len(rows)} bounces of the textured "
          f"render (live lanes: ms): {per_bounce}; "
          f"sum {render_ms:.3f} ms (+{stage_sum:.3f} ms), bound "
          f"{sum(r['bound'] for r in rows):.4f} ms ({card})")
    out.update(
        textured_launches=launched.get("pt_wave_bounce", 0),
        textured_launches_path=f"three textured coffee PT renders, {width}x{width}, {spp} spp, "
                               f"depth {depth}",
        textured_ms=rows[0]["ms"], textured_shade_ms=rows[0]["shade_ms"],
        textured_plain_ms=b_plain_full_ms, textured_bound_ms=rows[0]["bound"],
        textured_shape=f"the textured coffee PT render's first bounce, B={B0}",
        textured_render_ms=render_ms,
        textured_render_bound_ms=sum(r["bound"] for r in rows),
        textured_render_launches=[{k_: r[k_] for k_ in ("live", "ms", "texel_stage_ms")}
                                  for r in rows],
        texel_stage_ms=rows[0]["texel_stage_ms"], texel_stage_render_ms=stage_sum,
        texel_stage_wall_share=stage_sum / 1e3 / wall,
        textured_render_wall_s=wall, textured_within_tol=tw_frac,
        textured_max_abs_err=tw_err, textured_slice_plain_ms=b_plain_ms,
        textured_rays_traced=st.rays_traced,
        untextured_rays_traced=plain_render.stats.rays_traced)
    del bounces, results, plain_render, state, st_s, kb, pb, t, tri, hu, hv, rows
    lap("phase 23c")

    # ---- (d) scenes/earth.yaml through render(): PT, then BDPT-MIS
    earth = load_scene_from_yaml("scenes/earth.yaml", device=dev, verbose=False)
    shape = tuple(earth.scene.textures.images.shape)
    print(f"phase 23d: earth.yaml: {earth.scene.num_tris} triangles, Pillow "
          f"{'present' if has_pil else 'absent'}, image atlas {list(shape)}"
          f"{' (magenta fallback)' if shape[1:3] == (1, 1) else ''}")
    for integrator, want_route, want in (
            ("pt", "wave", {"closest_bvh", "pt_wave_bounce"}),
            ("bdpt-mis", "bdpt_wave", {"closest_bvh", "any_bvh"})):
        width, spp, depth = EARTH_RENDERS[integrator]
        cfg = dataclasses.replace(earth.camera, image_width=width, aspect_ratio=1.0,
                                  samples_per_pixel=spp, max_depth=depth, integrator=integrator,
                                  file_name=f"chip_smoke_earth_{integrator}.png")
        check(_route(earth.scene, cfg, integrator, None) == want_route,
              f"earth {integrator} is not routed to {want_route}")
        render(earth.scene, cfg, seed=0)  # warm-up
        zero_counts()
        results = [render(earth.scene, cfg, seed=0) for _ in range(2)]
        launched, n_plain = read_counts()
        check(set(launched) == want and not n_plain,
              f"earth {integrator} launched {launched}, plain calls {n_plain}")
        fb = results[0].framebuffer_sum
        check(bool(np.isfinite(fb).all()) and float(fb.mean()) > 0.0,
              f"earth {integrator}: non-finite or black image")
        check(np.array_equal(results[1].framebuffer_sum, fb),
              f"earth {integrator}: renders with the same seed differ")
        walls = [r.stats.wall_seconds for r in results]
        st = results[0].stats
        path = write_png(cfg.file_name, results[0].rgb8(), output_dir="output")
        print(f"phase 23d: render earth {integrator} {width}x{width} {spp} spp depth {depth} seed 0 "
              f"({want_route}): walls {[round(w, 6) for w in walls]} s, "
              f"{st.rays_traced / min(walls) / 1e6:.3f} Mrays/s on rays_traced "
              f"({(st.rays_traced + st.shadow_rays) / min(walls) / 1e6:.3f} with shadow rays); "
              f"rays_traced {st.rays_traced}, shadow_rays {st.shadow_rays}; launches {launched}, "
              f"plain calls {n_plain}; mean {float(fb.mean()) / cfg.effective_spp:.4f}; wrote "
              f"{path} ({card})")
        out[f"earth_{integrator}_walls_s"] = walls
    lap("phase 23d")
    return out


# phase 24's shapes: the cornell_smoke cases (rays: B, depth; pixels: width,
# sqrt spp, depth), the large volume scene's (rays and pixels: B, depth;
# the wave: B, depth), the large scene's renders (width, spp, depth)
VOL_RAYS = (65536, 10)
VOL_PIXELS = (64, 2, 16)
VOL_BIG_RAYS = (4096, 4)
VOL_BIG_WAVE = (8192, 6)
VOL_BIG_RENDER = {"pt": (256, 4, 8), "bdpt": (128, 4, 8), "pt defocus": (64, 4, 8)}
VOL_SLICE = 16  # the plain BDPT version runs on every 16th lane of rays mode
STRATA_CHUNK = 16  # strata a plain call when phase 24c counts the main path's override


def big_volume_scene(dev, texture=None):
    """tests/test_pallas_kernels.py:1189-1231's scene: the 964-triangle
    sphere, floor and light of big_scene with a constant-density box
    around the sphere (``texture``: its phase function's texture)."""
    from bpt_tpu_torch.scene.builder import MaterialSpec as MS, SceneBuilder

    b = SceneBuilder()
    b.add_uv_sphere((0, 1, 0), 1.0, MS.metal((0.8, 0.8, 0.8), 0.05))
    b.add_quad((-10, 0, -10), (20, 0, 0), (0, 0, 20), MS.lambertian((0.6, 0.6, 0.6)))
    b.add_quad((-2, 6, -2), (4, 0, 0), (0, 0, 4), MS.diffuse_light((10, 10, 10)))
    b.add_volume_box((-1.5, 0.01, -1.5), (1.5, 2.5, 1.5), density=0.2,
                     albedo=(0.9, 0.9, 0.9), texture=texture)
    return b.build(device=dev)


def big_volume_camera(width, spp, depth, integrator):
    """A camera at (0, 2, 6) looking at the volume box."""
    from bpt_tpu_torch.scene.types import CameraConfig

    return CameraConfig(image_width=width, samples_per_pixel=spp, max_depth=depth,
                        vfov=40.0, lookfrom=(0.0, 2.0, 6.0), lookat=(0.0, 1.0, 0.0),
                        integrator=integrator, file_name=f"chip_smoke_volume_{integrator}.png")


def vol_table_bytes(scene) -> int:
    from bpt_tpu_torch.ops.kernels import pt_kernel as pk

    return sum(t.numel() * t.element_size() for t in pk.pack_vol_tables(scene))


@contextlib.contextmanager
def vol_test_count():
    """The boundary tests that the kernels' free-flight override
    (csrc/volume.cuh) issues on the rays of the plain run inside the
    block, counted two ways.  'tests', as the first version issued them:
    each override of a live lane sweeps every volume's own triangles once
    (VT tests), and a volume's again where that first probe, over the
    whole line, hit it.  'issued', as the one-sweep probes (vol_probes)
    issue them: each volume's triangles once, and once more where the
    sweep dropped a valid t and kept none past t1 + 1e-4.  Every plain
    version overrides through
    ops.soa.volume_interaction, so this hooks it and the first probe's
    _vol_closest, counting on the device without a sync.  Yields a dict
    that holds, once the block ends, 'lanes' (the overrides), 'tests' and
    'issued'."""
    import torch

    from bpt_tpu_torch.ops import soa
    from bpt_tpu_torch.ops.kernels import pt_kernel as pk

    interaction, closest = soa.volume_interaction, soa._vol_closest
    live, lanes, tests, issued = [], [], [], []

    def hooked_interaction(scene, o, d, tmin, t_surf, u_rows, active):
        live[:] = [active]
        lanes.append(active.sum())
        tests.append(active.sum() * int(scene.vol_v0.shape[0]))
        return interaction(scene, o, d, tmin, t_surf, u_rows, active)

    def hooked_closest(scene, vid, o, d, tmin, tmax):
        t = closest(scene, vid, o, d, tmin, tmax)
        if not torch.is_tensor(tmin) and tmin == -torch.inf:  # the first probe
            rows = scene.vol_tri_vol == vid
            n_v = rows.sum()
            tests.append((live[0] & torch.isfinite(t)).sum() * n_v)
            det, tt, u, v = soa._mt_all(scene.vol_v0[rows], scene.vol_e1[rows],
                                        scene.vol_e2[rows], o, d)
            ok = soa._mt_valid(det, tt, u, v, -torch.inf, torch.inf) & torch.isfinite(tt)
            ts = torch.where(ok, tt, torch.inf).sort(dim=0).values
            kept = ts[:pk.VOL_KEEP]
            again = (ok.sum(0) > pk.VOL_KEEP) & ~(kept[1:] > kept[0] + 1e-4).any(0)
            issued.append((live[0].sum() + (live[0] & again).sum()) * n_v)
        return t

    out = {}
    soa.volume_interaction, soa._vol_closest = hooked_interaction, hooked_closest
    try:
        yield out
    finally:
        soa.volume_interaction, soa._vol_closest = interaction, closest
    out.update(lanes=int(sum(lanes)) if lanes else 0, tests=int(sum(tests)) if tests else 0,
               issued=int(sum(issued)) if issued else 0)


def vol_note(vt, rays: int) -> str:
    """What a bound counted of the override: its boundary tests and its
    lanes, beside the kernel's rays counter (a closest hit each; PT's also
    counts each path that reaches the depth limit)."""
    return (f"{vt['issued']} boundary tests issued with the one-sweep probes, "
            f"{vt['tests']} before them, on {vt['lanes']} overrides of the plain run, "
            f"the kernel's rays counter {rays}")


VOL_EDGE_RAYS = (4096, 3)  # phase 24b's lines at the volumes' boundaries: B, depth


def vol_edge_rays(scene, g, n):
    """Lines at the volumes' boundaries, where the override's one-sweep
    probes meet equal t's (tests/test_torch_volume_cull.py holds them on
    such lines on the CPU): from far away at a boundary triangle's corner,
    at a point of its edge, grazing its face at 1e-7 to 1e-2 radians, and
    from an origin on the plane of a volume's bounding box with that
    direction component zero.  (o, d) Vec3 of [n] on the scene's device."""
    import numpy as np
    import torch

    from bpt_tpu_torch.core.vec3 import Vec3
    from bpt_tpu_torch.ops.kernels import pt_kernel as pk

    vol = pk.pack_vol_tables(scene)[0].reshape(pk.MAX_VOL_TRIS, pk.VOL_STRIDE)
    vol = vol.cpu().double().numpy()
    o, d = np.empty((n, 3)), np.empty((n, 3))
    for i in range(n):
        v = i % scene.num_volumes
        rows = vol[vol[:, 9] == v]
        v0, e1, e2 = np.split(rows[g.integers(len(rows)), :9], 3)
        pts = np.concatenate([rows[:, 0:3], rows[:, 0:3] + rows[:, 3:6],
                              rows[:, 0:3] + rows[:, 6:9]])
        lo, hi = pts.min(0), pts.max(0)
        size = float((hi - lo).max())
        far = g.normal(size=3)
        far = (lo + hi) / 2 + far / np.linalg.norm(far) * 3 * size
        kind = (i // scene.num_volumes) % 4
        if kind < 2:
            tgt = v0 + (e1, e2, 0 * e1)[g.integers(3)] if kind == 0 else v0 + g.uniform() * e1
            o[i], d[i] = far, (tgt - far) * 10.0 ** g.uniform(-2, 2)
        elif kind == 2:
            nrm = np.cross(e1, e2)
            nrm /= np.linalg.norm(nrm)
            along = g.normal(size=3)
            along -= along.dot(nrm) * nrm
            along /= np.linalg.norm(along)
            ang = 10.0 ** g.uniform(-7, -2) * g.choice([-1.0, 1.0])
            d[i] = along * np.cos(ang) + nrm * np.sin(ang)
            a, b = g.uniform(size=2) * 0.5
            o[i] = v0 + a * e1 + b * e2 - d[i] * g.uniform(0.5, 3) * size
        else:
            ax = g.integers(3)
            o[i] = lo + g.uniform(-0.1, 1.1, 3) * (hi - lo)
            o[i, ax] = (lo, hi)[g.integers(2)][ax]
            d[i] = g.normal(size=3)
            d[i, ax] = 0.0
    ot = torch.from_numpy(o.astype(np.float32)).to(scene.device)
    dt = torch.from_numpy(d.astype(np.float32)).to(scene.device)
    return Vec3(*ot.unbind(1)), Vec3(*dt.unbind(1))


def sliced_vs_plain(what, mk, plain, args, kw, stride, atol):
    """A rays-mode launch over all lanes, its launch on every ``stride``-th
    lane equal to the bit to the whole launch there (a lane's sample
    depends on its ray, id and draws only), and that slice against the
    plain version.  Returns (the whole launch's outputs, the slice's
    fraction within tolerance, max abs err, plain ms, lanes compared)."""
    import torch

    from bpt_tpu_torch.core.vec3 import Vec3

    scene, o, d, ids, *rest = args
    full = mk(*args, **kw)
    sl = torch.arange(0, ids.shape[0], stride, device=ids.device)
    skw = dict(kw)
    if kw.get("uniforms") is not None:
        skw["uniforms"] = kw["uniforms"][:, sl].contiguous()
    s_args = (scene, Vec3(*(x[sl] for x in o)), Vec3(*(x[sl] for x in d)), ids[sl], *rest)
    kout = mk(*s_args, **skw)
    check(all(torch.equal(a[sl], b) for a, b in zip(full[:3], kout[:3])),
          f"{what}: the launch on every {stride}th lane differs from the whole launch there")
    pout, p_ms = timed(lambda: plain(*s_args, **skw))
    f, e = compare(f"{what}, every {stride}th lane (B={int(sl.numel())})", kout, pout,
                   exact_counts=True, atol=atol)
    return full, f, e, p_ms, int(sl.numel())


def volume_phases(dev, card, key, lap) -> dict:
    """Phase 24, volumes.  (a) scenes/cornell_smoke.yaml (two constant-
    density boxes) loads, and every megakernel takes it.  (b) Each volume
    mode against its plain version: pt_megakernel in rays mode (injected
    draws and the stream), pt_megakernel_pixels, bdpt_megakernel for bdpt
    and bdpt-mis in rays mode (on every 16th lane) and pixels mode on
    cornell_smoke; the walk mode of both megakernels and pt_wave
    (untextured and with a checker-textured volume) on the 964-triangle
    scene with a volume box.  rtol 1e-4 / atol 1e-6 (PT, the wave) or
    1e-5 (BDPT) on >= 99.9% of lanes, every counter exact.  (c) The
    slice's main path: cornell_smoke through render() at its own 256x256,
    64 spp, depth 16 with pt, bdpt and bdpt-mis, one warm-up and three
    timed renders each, one pixels-mode launch of the volume kernel a
    render, images bitwise repeatable; the CLI on the same scene in a
    subprocess.  (d) The large volume scene through render(): PT (pt_wave)
    and bdpt (the fused loop's walk mode), their rays on a pixel subset
    against the plain routes.  Returns the volume modes' kernel entries."""
    import numpy as np
    import torch

    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.core.vec3 import Vec3
    from bpt_tpu_torch.models.camera import camera_constants, generate_rays
    from bpt_tpu_torch.models.pt import NU
    from bpt_tpu_torch.models.render import _route, render
    from bpt_tpu_torch.ops.kernels import bdpt_kernel as bk
    from bpt_tpu_torch.ops.kernels import pt_kernel as pk
    from bpt_tpu_torch.ops.kernels import pt_wave as pw
    from bpt_tpu_torch.scene.loader import load_scene_from_yaml
    from bpt_tpu_torch.scene.textures import TextureSpec as TS
    from bpt_tpu_torch.utils.png import write_png

    wrappers = (pk.pt_megakernel, pk.pt_megakernel_pixels, bk.bdpt_megakernel,
                bk.bdpt_megakernel_pixels, pw.pt_wave_bounce)
    others = (pk.strata_sum, pw.closest_bvh, pw.any_bvh)
    plains = (pk.pt_megakernel_plain, pk.pt_megakernel_pixels_plain, pk.strata_sum_plain,
              bk.bdpt_megakernel_plain, bk.bdpt_megakernel_pixels_plain,
              pw.closest_bvh_plain, pw.any_bvh_plain, pw.pt_wave_bounce_plain,
              pw.pt_wave_plain)

    def zero_counts():
        for fn in wrappers:
            fn.launches = fn.vol_launches = 0
        for fn in others:
            fn.launches = 0
        for fn in plains:
            fn.calls = 0

    def read_counts():
        launched = {fn.__name__: fn.launches for fn in (*wrappers, *others) if fn.launches}
        vol = {fn.__name__: fn.vol_launches for fn in wrappers if fn.vol_launches}
        return launched, vol, sum(fn.calls for fn in plains)

    out = {}
    # ---- (a) the scene and the megakernels' reject reasons
    smoke = load_scene_from_yaml("scenes/cornell_smoke.yaml", device=dev, verbose=False)
    scene, cam_cfg = smoke.scene, smoke.camera
    reasons = {i: pk.megakernel_reject_reason(scene, i) for i in pk.INTEGRATORS}
    print(f"phase 24a: cornell_smoke.yaml: {scene.num_tris} triangles, {scene.num_volumes} "
          f"volumes over {int(scene.vol_v0.shape[0])} boundary triangles; "
          f"megakernel_reject_reason {reasons}")
    check(scene.num_volumes == 2 and all(r == "" for r in reasons.values()),
          f"cornell_smoke: volumes {scene.num_volumes}, reject reasons {reasons}")
    lap("phase 24a")

    # ---- (b) every volume mode against its plain version
    g = np.random.default_rng(24)
    B, depth = VOL_RAYS
    o3 = torch.tensor([278.0, 278.0, -800.0], device=dev).expand(B, 3)
    tgt = torch.from_numpy(g.uniform(50, 500, (B, 3)).astype(np.float32)).to(dev)
    ov, dv = Vec3(*o3.unbind(1)), Vec3(*(tgt - o3).unbind(1))
    ids = torch.arange(B, dtype=torch.int32, device=dev)
    nu = NU + scene.num_volumes
    ubuf = torch.from_numpy(g.uniform(size=(depth * nu, B)).astype(np.float32)).to(dev)
    entry = {}
    frac_pt, err_pt = 1.0, 0.0
    for mode, u in (("injected", ubuf), ("stream", None)):
        a = (scene, ov, dv, ids, key, depth)
        kout = pk.pt_megakernel(*a, uniforms=u)
        with vol_test_count() as vt:
            pout, p_ms = timed(lambda: pk.pt_megakernel_plain(*a, uniforms=u))
        f, e = compare(f"phase 24b: pt_megakernel volume mode, {mode} draws, cornell_smoke "
                       f"B={B} depth={depth}", kout, pout, exact_counts=True)
        frac_pt, err_pt = min(frac_pt, f), max(err_pt, e)
    rays_ms = time_ms(lambda: pk.pt_megakernel(*a), reps=10)
    c = counters(kout)
    rays_bound = bound(B * 40 + vol_table_bytes(scene), (c[3] + vt["issued"]) * MT_OPS)
    print(f"phase 24b: pt_megakernel volume mode, stream, B={B} depth={depth}: kernel "
          f"{rays_ms:.3f} ms, plain {p_ms:.3f} ms (one call), bound {rays_bound[0]:.4f} ms "
          f"({rays_bound[1]}; {c[3]} triangle tests, "
          f"{vol_note(vt, c[0])}) ({card})")
    W, S, pdepth = VOL_PIXELS
    cc = camera_constants(dataclasses.replace(cam_cfg, image_width=W, aspect_ratio=1.0,
                                              samples_per_pixel=S * S), torch.float32, dev)
    cam13 = pk.camera_table(cc)
    pix = torch.arange(W * W, dtype=torch.int64, device=dev)
    i, j = (pix % W).float(), (pix // W).float()
    a = (scene, i, j, i * 0, j * 0, pix, cam13, key, pdepth)
    kw = dict(spp_loop=S * S, sqrt_spp=S)
    kout = pk.pt_megakernel_pixels(*a, **kw)
    with vol_test_count() as vt:
        pout, px_plain_ms = timed(lambda: pk.pt_megakernel_pixels_plain(*a, **kw))
    f, e = compare(f"phase 24b: pt_megakernel_pixels volume mode, cornell_smoke {W}x{W} "
                   f"x {S * S} spp depth={pdepth}", kout, pout, exact_counts=True)
    frac_pt, err_pt = min(frac_pt, f), max(err_pt, e)
    px_ms = time_ms(lambda: pk.pt_megakernel_pixels(*a, **kw), reps=10)
    c = counters(kout)
    px_bound = bound(W * W * 32 + vol_table_bytes(scene), (c[3] + vt["issued"]) * MT_OPS)
    print(f"phase 24b: pt_megakernel_pixels volume mode {W}x{W} x {S * S} spp depth "
          f"{pdepth}: kernel {px_ms:.3f} ms, plain {px_plain_ms:.3f} ms, bound "
          f"{px_bound[0]:.4f} ms ({px_bound[1]}; {c[3]} triangle tests, "
          f"{vol_note(vt, c[0])}) ({card})")
    entry["pt"] = dict(frac=frac_pt, err=err_pt, rays_ms=rays_ms, rays_plain_ms=p_ms,
                       rays_bound=rays_bound, px_ms=px_ms, px_plain_ms=px_plain_ms,
                       px_bound=px_bound)
    lap("phase 24b (PT)")

    n_slots = bk.n_uniform_slots(depth, scene.num_volumes)
    ub = torch.from_numpy(g.uniform(size=(n_slots, B)).astype(np.float32)).to(dev)
    frac_b, err_b = 1.0, 0.0
    for mis in (False, True):
        name = "bdpt-mis" if mis else "bdpt"
        for mode, u in (("injected", ub), ("stream", None)):
            full, f, e, b_plain_ms, n = sliced_vs_plain(
                f"phase 24b: bdpt_megakernel volume mode {name}, {mode} draws, cornell_smoke "
                f"B={B} depth={depth}", bk.bdpt_megakernel, bk.bdpt_megakernel_plain,
                (scene, ov, dv, ids, key, depth), dict(uniforms=u, mis=mis), VOL_SLICE,
                BDPT_ATOL)
            frac_b, err_b = min(frac_b, f), max(err_b, e)
        a = (scene, i, j, pix, cam13, key, pdepth, S)
        kout = bk.bdpt_megakernel_pixels(*a, mis=mis)
        with vol_test_count() as vt_px:
            pout, bpx_plain_ms = timed(lambda: bk.bdpt_megakernel_pixels_plain(*a, mis=mis))
        f, e = compare(f"phase 24b: bdpt_megakernel_pixels volume mode {name}, cornell_smoke "
                       f"{W}x{W} x {S * S} spp depth={pdepth}", kout, pout, exact_counts=True,
                       atol=BDPT_ATOL)
        frac_b, err_b = min(frac_b, f), max(err_b, e)
        if not mis:
            b_rays_ms = time_ms(lambda: bk.bdpt_megakernel(scene, ov, dv, ids, key, depth),
                                reps=5)
            # the timed launch's override count: the plain version on all its lanes
            with vol_test_count() as vt:
                bk.bdpt_megakernel_plain(scene, ov, dv, ids, key, depth)
            c = counters(full)
            b_rays_bound = bound(B * 40 + vol_table_bytes(scene),
                                 (c[4] + vt["issued"]) * MT_OPS)
            bpx_ms = time_ms(lambda: bk.bdpt_megakernel_pixels(*a), reps=5)
            cp = counters(kout)
            bpx_bound = bound(W * W * 24 + vol_table_bytes(scene),
                              (cp[4] + vt_px["issued"]) * MT_OPS)
            print(f"phase 24b: bdpt_megakernel volume mode bdpt: rays B={B} depth={depth} "
                  f"kernel {b_rays_ms:.3f} ms, plain on every {VOL_SLICE}th lane "
                  f"{b_plain_ms:.3f} ms, bound {b_rays_bound[0]:.4f} ms ({b_rays_bound[1]}; "
                  f"{c[4]} triangle tests, {vol_note(vt, c[0])}); pixels {W}x{W} x {S * S} "
                  f"spp depth {pdepth} kernel {bpx_ms:.3f} ms, plain {bpx_plain_ms:.3f} ms, "
                  f"bound {bpx_bound[0]:.4f} ms ({bpx_bound[1]}; {cp[4]} triangle tests, "
                  f"{vol_note(vt_px, cp[0])}) ({card})")
            entry["bdpt"] = dict(rays_ms=b_rays_ms, rays_plain_ms=b_plain_ms,
                                 rays_bound=b_rays_bound, px_ms=bpx_ms,
                                 px_plain_ms=bpx_plain_ms, px_bound=bpx_bound)
    entry["bdpt"].update(frac=frac_b, err=err_b)
    # the override's edge lanes: every lane of a launch against the plain
    # version, counters exact
    Be, de = VOL_EDGE_RAYS
    oe, dee = vol_edge_rays(scene, g, Be)
    ide = torch.arange(Be, dtype=torch.int32, device=dev)
    ue = torch.from_numpy(g.uniform(size=(de * nu, Be)).astype(np.float32)).to(dev)
    ue5 = torch.from_numpy(g.uniform(size=(bk.n_uniform_slots(de, scene.num_volumes), Be))
                           .astype(np.float32)).to(dev)
    for name, mk, plain, u, atol, mis in (
            ("pt", pk.pt_megakernel, pk.pt_megakernel_plain, ue, ATOL, False),
            ("bdpt", bk.bdpt_megakernel, bk.bdpt_megakernel_plain, ue5, BDPT_ATOL, False),
            ("bdpt-mis", bk.bdpt_megakernel, bk.bdpt_megakernel_plain, None, BDPT_ATOL, True)):
        kw_ = dict(uniforms=u, **({"mis": True} if mis else {}))
        a = (scene, oe, dee, ide, key, de)
        f, e = compare(f"phase 24b: {mk.__name__} volume mode {name} on {Be} lines at the "
                       f"volumes' boundaries (corners, edges, grazing, box planes), depth {de}",
                       mk(*a, **kw_), plain(*a, **kw_), exact_counts=True, atol=atol)
        k = "pt" if name == "pt" else "bdpt"
        entry[k]["frac"], entry[k]["err"] = min(entry[k]["frac"], f), max(entry[k]["err"], e)
    lap("phase 24b (BDPT)")

    # the walk mode and the wave on the 964-triangle scene with a volume box
    big = big_volume_scene(dev)
    check(big.use_bvh and pk.use_walk(big) and big.num_volumes == 1
          and not pk.megakernel_reject_reason(big, "bdpt"),
          "the large volume scene is not a walk-mode volume scene")
    Bw, dw = VOL_BIG_RAYS
    ob = torch.tensor([0.0, 2.0, 6.0], device=dev).expand(Bw, 3)
    tb = torch.from_numpy(np.c_[g.uniform(-2, 2, Bw), g.uniform(0, 3, Bw),
                                np.zeros(Bw)].astype(np.float32)).to(dev)
    obv, dbv = Vec3(*ob.unbind(1)), Vec3(*(tb - ob).unbind(1))
    idb = torch.arange(Bw, dtype=torch.int32, device=dev)
    walk = {}
    ub_pt = torch.from_numpy(g.uniform(size=(dw * (NU + 1), Bw)).astype(np.float32)).to(dev)
    ub_bd = torch.from_numpy(g.uniform(size=(bk.n_uniform_slots(dw, 1), Bw))
                             .astype(np.float32)).to(dev)
    tab = walk_table_bytes(big) + vol_table_bytes(big)
    # the plain walks run in torch: both draw modes of PT, bdpt on injected
    # draws and bdpt-mis on the stream
    for name, mk, plain, modes, atol, extra in (
            ("pt", pk.pt_megakernel, pk.pt_megakernel_plain,
             (("injected", ub_pt), ("stream", None)), ATOL, {}),
            ("bdpt", bk.bdpt_megakernel, bk.bdpt_megakernel_plain, (("injected", ub_bd),),
             BDPT_ATOL, {}),
            ("bdpt-mis", bk.bdpt_megakernel, bk.bdpt_megakernel_plain, (("stream", None),),
             BDPT_ATOL, dict(mis=True))):
        fr, er = 1.0, 0.0
        for mode, uu in modes:
            a = (big, obv, dbv, idb, key, dw)
            kout = mk(*a, uniforms=uu, **extra)
            with vol_test_count() as vt:
                pout, w_plain_ms = timed(lambda: plain(*a, uniforms=uu, **extra))
            f, e = compare(f"phase 24b: {mk.__name__} walk volume mode {name}, {mode} draws, "
                           f"large volume scene B={Bw} depth={dw}", kout, pout,
                           exact_counts=True, atol=atol)
            fr, er = min(fr, f), max(er, e)
        # timed on the last mode's draws, the inputs of its counters and count
        w_ms = time_ms(lambda: mk(*a, uniforms=uu, **extra), reps=5)
        c = counters(kout)
        nodes, tests = (c[1], c[3]) if name == "pt" else (c[2], c[4])
        wb = bound(Bw * 40 + tab, nodes * SLAB_OPS + (tests + vt["issued"]) * MT_OPS)
        walk[name] = dict(frac=fr, err=er, ms=w_ms, plain_ms=w_plain_ms, bound=wb)
        print(f"phase 24b: {mk.__name__} walk volume mode {name} B={Bw} depth={dw} ({mode} "
              f"draws): kernel {w_ms:.3f} ms, plain {w_plain_ms:.3f} ms, bound {wb[0]:.4f} ms "
              f"({wb[1]}; {nodes} slab and {tests} triangle tests, {vol_note(vt, c[0])}) "
              f"({card})")
    Wb = 32
    cfg_b = big_volume_camera(Wb, 4, dw, "bdpt")
    ccb = camera_constants(cfg_b, torch.float32, dev)
    pixb = torch.arange(Wb * Wb, dtype=torch.int64, device=dev)
    ib, jb = (pixb % Wb).float(), (pixb // Wb).float()
    for name, mk, plain, a, kw_, atol in (
            ("pt", pk.pt_megakernel_pixels, pk.pt_megakernel_pixels_plain,
             (big, ib, jb, ib * 0, jb * 0, pixb, pk.camera_table(ccb), key, dw),
             dict(spp_loop=4, sqrt_spp=2), ATOL),
            ("bdpt-mis", bk.bdpt_megakernel_pixels, bk.bdpt_megakernel_pixels_plain,
             (big, ib, jb, pixb, pk.camera_table(ccb), key, dw, 2), dict(mis=True),
             BDPT_ATOL)):
        kout = mk(*a, **kw_)
        pout = plain(*a, **kw_)
        f, e = compare(f"phase 24b: {mk.__name__} walk volume mode {name}, large volume "
                       f"scene {Wb}x{Wb} x 4 spp depth={dw}", kout, pout, exact_counts=True,
                       atol=atol)
        key_ = "pt" if name == "pt" else "bdpt"
        walk[key_]["frac"] = min(walk[key_]["frac"], f)
        walk[key_]["err"] = max(walk[key_]["err"], e)
    lap("phase 24b (walk)")

    key_pt = rng.fold_in(key, 1)
    Bv, dv_ = VOL_BIG_WAVE
    wave = {}
    for tex_name, tex in (("untextured", None),
                          ("checker-textured volume", TS.checker(0.35, (0.9, 0.3, 0.2),
                                                                 (0.2, 0.4, 0.9)))):
        sc = big_volume_scene(dev, texture=tex)
        check(sc.has_textures == (tex is not None), "the textured volume scene's flag")
        ow = torch.tensor([0.0, 2.0, 6.0], device=dev).expand(Bv, 3)
        tw = torch.from_numpy(np.c_[g.uniform(-2, 2, Bv), g.uniform(0, 3, Bv),
                                    np.zeros(Bv)].astype(np.float32)).to(dev)
        owv, dwv = Vec3(*ow.unbind(1)), Vec3(*(tw - ow).unbind(1))
        idw = torch.arange(Bv, dtype=torch.int32, device=dev)
        zero_counts()
        kout = pw.pt_wave(sc, owv, dwv, idw, key_pt, dv_)
        torch.cuda.synchronize()
        launched, vol, n_plain = read_counts()
        check(vol == {"pt_wave_bounce": dv_} and launched.get("closest_bvh") == dv_
              and not n_plain, f"pt_wave {tex_name}: launches {launched}, volume mode "
                               f"{vol}, plain calls {n_plain}")
        with vol_test_count() as vt:
            pout, wp_ms = timed(lambda: pw.pt_wave_plain(sc, owv, dwv, idw, key_pt, dv_))
        f, e = compare(f"phase 24b: pt_wave volume mode, {tex_name}, large volume scene "
                       f"B={Bv} depth={dv_}", kout, pout, exact_counts=True)
        check(float(torch.stack(kout[:3]).sum()) > 0, f"pt_wave {tex_name}: black")
        wk_ms = time_ms(lambda: pw.pt_wave(sc, owv, dwv, idw, key_pt, dv_), reps=5)
        c = counters(kout)
        wb = bound(Bv * 40 * dv_ + dv_ * (walk_table_bytes(sc) + vol_table_bytes(sc)),
                   c[1] * SLAB_OPS + (c[3] + vt["issued"]) * MT_OPS)
        print(f"phase 24b: pt_wave volume mode, {tex_name}: kernels {wk_ms:.3f} ms (the "
              f"{dv_} bounces' walks and shades), plain {wp_ms:.3f} ms, bound {wb[0]:.4f} ms "
              f"({wb[1]}; {vol_note(vt, c[0])}) ({card})")
        wave[tex_name] = dict(frac=f, err=e, ms=wk_ms, plain_ms=wp_ms, bound=wb)
    lap("phase 24b (wave)")

    # ---- (c) the slice's main path: cornell_smoke at its own configuration
    renders = {}
    for integrator in pk.INTEGRATORS:
        cfg = dataclasses.replace(cam_cfg, integrator=integrator,
                                  file_name=f"chip_smoke_cornell_smoke_{integrator}.png")
        check(_route(scene, cfg, integrator, None) == "fused",
              f"cornell_smoke {integrator} is not routed to the fused loop")
        render(scene, cfg, seed=0)  # warm-up
        zero_counts()
        results = [render(scene, cfg, seed=0) for _ in range(3)]
        launched, vol, n_plain = read_counts()
        mk = "pt_megakernel_pixels" if integrator == "pt" else "bdpt_megakernel_pixels"
        check(vol == {mk: 3} and launched == {mk: 3, "strata_sum": 3} and not n_plain,
              f"cornell_smoke {integrator}: launches {launched}, volume mode {vol}, plain "
              f"calls {n_plain}")
        fb = results[0].framebuffer_sum
        check(bool(np.isfinite(fb).all()) and float(fb.mean()) > 0.0,
              f"cornell_smoke {integrator}: non-finite or black image")
        check(all(np.array_equal(r.framebuffer_sum, fb) for r in results[1:]),
              f"cornell_smoke {integrator}: renders with one seed differ")
        walls = [r.stats.wall_seconds for r in results]
        wall = statistics.median(walls)
        st = results[0].stats
        path = write_png(cfg.file_name, results[0].rgb8(), output_dir="output")
        digest = hashlib.sha256(np.ascontiguousarray(fb).tobytes()).hexdigest()[:16]
        print(f"phase 24c: render cornell_smoke {integrator} {cfg.image_width}x"
              f"{cfg.image_height} {cfg.samples_per_pixel} spp depth {cfg.max_depth} seed 0 "
              f"(fused): walls {[round(w, 6) for w in walls]} s, median {wall:.6f} s, "
              f"{st.rays_traced / wall / 1e6:.3f} Mrays/s on rays_traced "
              f"({(st.rays_traced + st.shadow_rays) / wall / 1e6:.3f} with shadow rays); "
              f"rays_traced {st.rays_traced}, shadow_rays {st.shadow_rays}, tri tests "
              f"{st.triangle_tests}, tri hits {st.triangle_hits}; launches {launched} (volume mode "
              f"{vol}), plain calls {n_plain}; mean {float(fb.mean()) / cfg.effective_spp:.5f};"
              f" framebuffer sha256 {digest}; wrote {path} ({card})")
        renders[integrator] = dict(walls=walls, wall=wall, rays=st.rays_traced,
                                   shadow=st.shadow_rays, launches=vol.get(mk, 0),
                                   tests=st.triangle_tests, tri_hits=st.triangle_hits,
                                   npix=cfg.image_width * cfg.image_height)
    # the main path's launch on its own, at the render's shape (one chunk)
    npx = cam_cfg.image_width * cam_cfg.image_height
    S = cam_cfg.sqrt_spp
    ccs = camera_constants(cam_cfg, torch.float32, dev)
    pixs = torch.arange(npx, dtype=torch.int64, device=dev)
    i_s, j_s = (pixs % cam_cfg.image_width).float(), (pixs // cam_cfg.image_width).float()
    main_args = {
        "pt": (pk.pt_megakernel_pixels, (scene, i_s, j_s, i_s * 0, j_s * 0, pixs,
                                         pk.camera_table(ccs), key, cam_cfg.max_depth),
               dict(spp_loop=S * S, sqrt_spp=S)),
        "bdpt": (bk.bdpt_megakernel_pixels, (scene, i_s, j_s, pixs, pk.camera_table(ccs), key,
                                             cam_cfg.max_depth, S), {}),
        "bdpt-mis": (bk.bdpt_megakernel_pixels, (scene, i_s, j_s, pixs, pk.camera_table(ccs),
                                                 key, cam_cfg.max_depth, S), dict(mis=True)),
    }
    # the boundary tests of that launch: the rays-mode plain version on its
    # samples (every pixel and stratum, on the pixels mode's ray ids and
    # jitter), STRATA_CHUNK strata a call; bdpt and bdpt-mis trace the same
    # subpaths, so they share one count
    vt_main = {}
    for name, bdpt in (("pt", False), ("bdpt", True)):
        lanes = tests = issued = rays = 0
        for k0 in range(0, S * S, STRATA_CHUNK):
            o_, d_, id_ = wave_rays(ccs, pixs, min(STRATA_CHUNK, S * S - k0), key, dev,
                                    first=k0, bdpt=bdpt)
            with vol_test_count() as vt:
                if bdpt:
                    pr = bk.bdpt_megakernel_plain(scene, o_, d_, id_, key, cam_cfg.max_depth)
                else:
                    pr = pk.pt_megakernel_plain(scene, o_, d_, id_, rng.fold_in(key, 1),
                                                cam_cfg.max_depth)
            lanes, tests, rays = lanes + vt["lanes"], tests + vt["tests"], rays + int(pr[3])
            issued += vt["issued"]
        vt_main[name] = dict(lanes=lanes, tests=tests, issued=issued, rays=rays)
    vt_main["bdpt-mis"] = vt_main["bdpt"]
    for integrator, (mk, a, kw_) in main_args.items():
        ms = time_ms(lambda: mk(*a, **kw_), reps=3)
        c = counters(mk(*a, **kw_))
        tests, vt = c[3] if integrator == "pt" else c[4], vt_main[integrator]
        check(abs(vt["rays"] - c[0]) <= 1e-3 * c[0],
              f"cornell_smoke {integrator}: the plain run's rays {vt['rays']} against the "
              f"launch's {c[0]}")
        r = renders[integrator]
        nbytes = npx * 32 + vol_table_bytes(scene)
        r["ms"], r["bound"] = ms, bound(nbytes, (tests + vt["issued"]) * MT_OPS)
        r["bound_before"] = bound(nbytes, (tests + vt["tests"]) * MT_OPS)
        r["tests_main"], r["vol_tests_main"] = tests, vt["issued"]
        print(f"phase 24c: {mk.__name__} {integrator} at the main path's shape ({npx} pixels x "
              f"{S * S} spp, depth {cam_cfg.max_depth}): {ms:.3f} ms, bound {r['bound'][0]:.4f} "
              f"ms ({r['bound'][1]}; {r['bound_before'][0]:.4f} ms charged as before the "
              f"one-sweep probes; {tests} triangle tests, {vol_note(vt, c[0])}, the plain run's "
              f"{vt['rays']}) ({card})")
    cli = subprocess.run([sys.executable, "-m", "bpt_tpu_torch.render",
                          "scenes/cornell_smoke.yaml", "--no-progress", "--output-dir", "output"],
                         capture_output=True, text=True, timeout=300)
    print(f"phase 24c: python -m bpt_tpu_torch.render scenes/cornell_smoke.yaml: exit "
          f"{cli.returncode}; {' / '.join(cli.stderr.strip().splitlines()[-3:])}")
    check(cli.returncode == 0, f"the CLI on cornell_smoke exited {cli.returncode}: "
                               f"{cli.stderr[-2000:]}")
    lap("phase 24c")

    # ---- (d) the large volume scene through render(), rays against the plain
    # routes: PT through pt_wave, bdpt through the fused loop's walk mode, and
    # PT with defocus through the stratum loop (the rays mode's walk)
    launches_24d = {}
    for case, integrator, want_route, mk_names in (
            ("pt", "pt", "wave", {"closest_bvh", "pt_wave_bounce"}),
            ("bdpt", "bdpt", "fused", {"bdpt_megakernel_pixels", "strata_sum"}),
            ("pt defocus", "pt", "strata", {"pt_megakernel"})):
        width, spp, depth_r = VOL_BIG_RENDER[case]
        cfg = big_volume_camera(width, spp, depth_r, integrator)
        if case == "pt defocus":
            cfg = dataclasses.replace(cfg, defocus_angle=1.0, focus_dist=5.0,
                                      file_name="chip_smoke_volume_pt_defocus.png")
        check(_route(big, cfg, integrator, None) == want_route,
              f"the large volume scene's {case} is not routed to {want_route}")
        render(big, cfg, seed=0)  # warm-up
        zero_counts()
        res = render(big, cfg, seed=0)
        launched, vol, n_plain = read_counts()
        check(set(launched) == mk_names and set(vol) == mk_names - {"closest_bvh", "strata_sum"}
              and not n_plain, f"large volume {case}: launches {launched}, volume "
                               f"mode {vol}, plain calls {n_plain}")
        launches_24d[case] = sum(vol.values())
        fb = res.framebuffer_sum
        check(bool(np.isfinite(fb).all()) and float(fb.mean()) > 0.0,
              f"large volume {case}: non-finite or black image")
        st = res.stats
        write_png(cfg.file_name, res.rgb8(), output_dir="output")
        line = (f"phase 24d: render large volume scene {case} {width}x{width} {spp} spp depth "
                f"{depth_r} ({want_route}): wall {st.wall_seconds:.6f} s, rays_traced "
                f"{st.rays_traced}, shadow_rays {st.shadow_rays}; launches {launched} (volume "
                f"mode {vol}), plain calls {n_plain}")
        if case == "pt defocus":
            print(f"{line} ({card})")
            continue
        # every 257th pixel, all strata, on the render's own stream: the
        # route's kernels against its plain route
        ccr = camera_constants(cfg, torch.float32, dev)
        sub = torch.arange(0, width * width, 257, device=dev)
        k0 = rng.prng_key(0)
        if integrator == "pt":
            o_, d_, id_ = wave_rays(ccr, sub, spp, k0, dev)
            kr = pw.pt_wave(big, o_, d_, id_, rng.fold_in(k0, 1), depth_r)
            pr = pw.pt_wave_plain(big, o_, d_, id_, rng.fold_in(k0, 1), depth_r)
        else:
            a = (big, (sub % width).float(), (sub // width).float(), sub,
                 pk.camera_table(ccr), k0, depth_r, cfg.sqrt_spp)
            kr = bk.bdpt_megakernel_pixels(*a)
            pr = bk.bdpt_megakernel_pixels_plain(*a)
        compare(f"phase 24d: large volume {case} on every 257th pixel x {spp} strata "
                f"({want_route} route vs its plain route)", kr, pr, exact_counts=True,
                atol=ATOL if integrator == "pt" else BDPT_ATOL)
        print(f"{line}; subset rays {counters(kr)[0]} = plain {counters(pr)[0]} ({card})")
    lap("phase 24d")
    out.update(entry=entry, walk=walk, wave=wave, renders=renders, launches_24d=launches_24d)
    return out


def volume_entries(vol) -> list:
    """The kernels line's entries of the volume kernels (phase 24)."""
    e, w, r = vol["entry"], vol["walk"], vol["renders"]
    smoke = "cornell_smoke.yaml, 256x256, 64 spp, depth 16"
    base = dict(route="cuda", library_ms=None)

    def pix(name, src, tpu, mode, integrators):
        k = e[mode]
        main = r[integrators[0]]
        return dict(
            base, name=name, source=f"bpt_tpu_torch/csrc/{src}", replaces=tpu,
            launches=sum(r[i]["launches"] for i in integrators),
            launches_path=f"three renders of {smoke} with each of {', '.join(integrators)}",
            max_abs_err=k["err"], within_tol=k["frac"], ms=main["ms"], bound_ms=main["bound"][0],
            bound_by=main["bound"][1], bound_charged_before_ms=main["bound_before"][0],
            shape=f"the one launch of a {integrators[0]} render of {smoke}",
            plain_ms=k["px_plain_ms"], plain_shape="cornell_smoke 64x64 x 4 spp, depth 16",
            small_ms=k["px_ms"], small_bound_ms=k["px_bound"][0],
            rays_mode_ms=k["rays_ms"], rays_mode_plain_ms=k["rays_plain_ms"],
            rays_mode_bound_ms=k["rays_bound"][0],
            render_walls_s={i: r[i]["walls"] for i in integrators},
            render_rays={i: r[i]["rays"] for i in integrators},
            render_shadow_rays={i: r[i]["shadow"] for i in integrators},
            **({"mis_ms": r["bdpt-mis"]["ms"]} if mode == "bdpt" else {}))

    d24 = vol["launches_24d"]
    walk_path = {"pt": ("pt defocus", "one PT render of the large volume scene with defocus, "
                                      "64x64, 4 spp, depth 8 (the stratum loop, rays mode)"),
                 "bdpt": ("bdpt", "one bdpt render of the large volume scene, 128x128, 4 spp, "
                                  "depth 8 (the fused loop, pixels mode)")}
    walk_e = [dict(base, name=f"{k}_megakernel_walk_vol",
                   source=f"bpt_tpu_torch/csrc/{k}_megakernel.cu",
                   replaces=f"bpt_tpu/ops/pallas/"
                            f"{'pt_kernel.py:1207' if k == 'pt' else 'bdpt_kernel.py:1195'} "
                            "(clustered mode, volumes)",
                   launches=d24[walk_path[k][0]], launches_path=walk_path[k][1],
                   max_abs_err=w[k]["err"], within_tol=w[k]["frac"], ms=w[k]["ms"],
                   plain_ms=w[k]["plain_ms"], bound_ms=w[k]["bound"][0], bound_by=w[k]["bound"][1],
                   shape=f"the large volume scene, B={VOL_BIG_RAYS[0]}, depth {VOL_BIG_RAYS[1]}")
              for k in ("pt", "bdpt")]
    wv = vol["wave"]
    return [
        pix("pt_megakernel_vol", "pt_megakernel.cu", "bpt_tpu/ops/pallas/pt_kernel.py:1334 "
            "(volume mode; rays mode :1207)", "pt", ["pt"]),
        pix("bdpt_megakernel_vol", "bdpt_megakernel.cu", "bpt_tpu/ops/pallas/bdpt_kernel.py:1314 "
            "(volume mode; rays mode :1195)", "bdpt", ["bdpt", "bdpt-mis"]),
        *walk_e,
        dict(base, name="pt_wave_bounce_vol", source="bpt_tpu_torch/csrc/pt_wave.cu",
             replaces="bpt_tpu/ops/pallas/pt_wave.py:326 (volume mode)",
             launches=d24["pt"],
             launches_path="one render of the large volume scene with pt, 256x256, 4 spp, "
                           "depth 8 (phase 24d)",
             max_abs_err=max(x["err"] for x in wv.values()),
             within_tol=min(x["frac"] for x in wv.values()),
             ms=wv["untextured"]["ms"], plain_ms=wv["untextured"]["plain_ms"],
             bound_ms=wv["untextured"]["bound"][0], bound_by=wv["untextured"]["bound"][1],
             shape=f"pt_wave on the large volume scene, B={VOL_BIG_WAVE[0]}, depth "
                   f"{VOL_BIG_WAVE[1]}: closest_bvh and this kernel a bounce",
             textured_ms=wv["checker-textured volume"]["ms"],
             textured_plain_ms=wv["checker-textured volume"]["plain_ms"]),
    ]


# phase 25's shapes: the main path's (width, spp, depth) and the ref_vis
# route's; the meshes of (a)
DIST_MAIN = (512, 16, 10)
DIST_REFVIS = (64, 16, 10)
DIST_MESHES = {"cornell": (4, 3), "coffee": (2,)}


def zero_launch_counts():
    """Sets every kernel wrapper's launch count (and volume-mode count)
    and every plain version's call count to 0."""
    from bpt_tpu_torch.ops import soa
    from bpt_tpu_torch.ops.kernels import (
        bdpt_kernel,
        cluster_wave,
        intersect,
        plucker,
        pt_kernel,
        pt_wave,
    )

    for mod in (pt_kernel, bdpt_kernel, pt_wave, intersect, cluster_wave, plucker, soa):
        for fn in vars(mod).values():
            for attr in ("launches", "vol_launches", "f64_launches", "calls"):
                if callable(fn) and hasattr(fn, attr):
                    setattr(fn, attr, 0)


def distributed_phases(dev, card, refs, coffee, lap) -> dict:
    """Phase 25, multi-device rendering and render_resilient on the card.
    ``refs``: render() of the cornell box with pt, bdpt and bdpt-mis
    (phase 3) and of the coffee stand-in with pt (phase 8) and bdpt-mis
    (phase 10), by (scene, integrator).  (a) render_distributed on
    [cuda:0] x 4 and x 3 (cornell, 512x512, 16 spp, depth 10) and x 2
    (coffee PT at 16 spp, bdpt-mis at 4): image and counters equal to
    render()'s to the bit, the route's kernels launched and no plain
    version; walls of one warm-up and three renders.  (b)
    render_spp_sharded over [cuda:0] x 4, strata s0 + d summed in device
    order, for cornell pt, pt with defocus and bdpt at 512x512, 16 spp,
    depth 10: within rtol 1e-5 / atol 1e-6 of the single-device stratum
    loop, rays equal, pt_megakernel (rows 1-2) and bdpt_megakernel (row
    5) launched; one pixel-sharded ref_vis bdpt render (64x64, 16 spp,
    depth 10) over x 2 equal to render()'s, closest_tri / any_tri
    launched.  (c) launch_local(2, device="cuda", backend="gloo") for
    cornell bdpt and coffee PT at the main path's shape: the gathered
    .npy equal to render()'s, each rank's printed launches > 0 and no
    plain call.  (d) render_resilient: cornell bdpt on the fused route in
    4 chunks of 65,536 pixels failing once at chunk 2, and coffee PT on
    pt_wave in batches of 4 strata failing once after the first: each
    equal to the uninterrupted render to the bit.  Returns the kernels'
    launches under (a)-(d)."""
    import numpy as np
    import torch

    from bpt_tpu_torch.models import render as render_mod
    from bpt_tpu_torch.models.camera import camera_constants
    from bpt_tpu_torch.parallel import render_distributed, render_spp_sharded
    from bpt_tpu_torch.parallel.multiprocess import launch_local
    from bpt_tpu_torch.parallel.worker import launch_counts
    from bpt_tpu_torch.scene.presets import cornell_box, cornell_box_camera

    width, spp, depth = DIST_MAIN
    scenes = {"cornell": cornell_box(device=dev), "coffee": coffee}
    cams = {"cornell": lambda i, **kw: dataclasses.replace(
                cornell_box_camera(), image_width=width, samples_per_pixel=spp,
                max_depth=depth, integrator=i, **kw),
            "coffee": lambda i: coffee_camera(width, spp if i == "pt" else 4, depth, i)}
    totals = {}

    def drive(fn):
        """Runs one drive of phase 25's paths with every count at 0 before
        it; adds its kernel launches to the phase's totals.  Returns (fn's
        result, launches, plain calls)."""
        zero_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        launched, calls = launch_counts()
        for k, n in launched.items():
            totals[k] = totals.get(k, 0) + n
        return out, launched, calls

    def same_counts(a, b):
        return dataclasses.replace(a, wall_seconds=0) == dataclasses.replace(b, wall_seconds=0)

    # ---- (a) pixel sharding in one process
    for (sname, integ), ref in refs.items():
        scene, cfg = scenes[sname], cams[sname](integ)
        route = render_mod._route(scene, cfg, integ, None)
        check(route == {"cornell": "fused", "coffee": "wave" if integ == "pt" else "bdpt_wave"}
              [sname], f"phase 25a: {sname} {integ} takes route {route}")
        for n in DIST_MESHES[sname]:
            mesh = [dev] * n
            render_distributed(scene, cfg, mesh=mesh, seed=0)  # warm-up
            runs, launched, calls = drive(lambda: [render_distributed(scene, cfg, mesh=mesh, seed=0)
                                                   for _ in range(3)])
            w = [st.wall_seconds for _, _, st in runs]
            st = runs[0][2]
            check(all(np.array_equal(f, ref.framebuffer_sum) for f, _, _ in runs),
                  f"phase 25a: {sname} {integ} over {n} devices differs from render()")
            check(same_counts(st, ref.stats),
                  f"phase 25a: {sname} {integ} over {n} devices: counters {st} != {ref.stats}")
            needed = {"fused": ("pt_megakernel_pixels",) if integ == "pt"
                      else ("bdpt_megakernel_pixels",),
                      "wave": ("closest_bvh", "pt_wave_bounce"),
                      "bdpt_wave": ("closest_bvh", "any_bvh")}[route]
            check(all(launched.get(k, 0) > 0 for k in needed) and not calls,
                  f"phase 25a: {sname} {integ} x{n} ({route}): launches {launched}, plain {calls}")
            print(f"phase 25a: render_distributed {sname} {integ} {width}x{width} "
                  f"{cfg.samples_per_pixel} spp depth {depth} over [cuda:0] x {n} ({route}): "
                  f"image and counters equal to render()'s (rays {st.rays_traced}, shadow "
                  f"{st.shadow_rays}); walls {[round(x, 6) for x in w]} s, median "
                  f"{statistics.median(w):.6f} s (render() {ref.stats.wall_seconds:.6f} s); "
                  f"launches {launched} ({card})")
    lap("phase 25a")

    # ---- (b) sample sharding against the single-device stratum loop, and
    # a pixel-sharded ref_vis render through the brute-force hit kernels
    cornell = scenes["cornell"]
    for name, integ, kw, kernel in (("pt", "pt", {}, "pt_megakernel_pixels"),
                                    ("pt defocus", "pt", dict(defocus_angle=1.0,
                                                              focus_dist=1078.0), "pt_megakernel"),
                                    ("bdpt", "bdpt", {}, "bdpt_megakernel")):
        cfg = cams["cornell"](integ, **kw)
        cc = camera_constants(cfg, torch.float32, dev)
        fb1 = torch.zeros((width * width, 3), device=dev)
        rays1 = int(render_mod._render_strata(cornell, cfg, cc, integ, 0, fb1, None, None, None)[0])
        want = fb1.cpu().numpy().reshape(width, width, 3)

        def sharded():
            fb, rays, wall = 0.0, 0, 0.0
            for s0 in range(0, spp, 4):
                part, st = render_spp_sharded(cornell, cfg, mesh=[dev] * 4, seed=0, s0=s0)
                fb, rays, wall = fb + part, rays + st.rays_traced, wall + st.wall_seconds
            return fb, rays, wall

        (fb, rays, wall), launched, calls = drive(sharded)
        err = float(np.abs(fb - want).max())
        check(np.allclose(fb, want, rtol=1e-5, atol=1e-6) and rays == rays1,
              f"phase 25b: spp-sharded {name}: max abs err {err}, rays {rays} vs {rays1}")
        check(launched.get(kernel, 0) >= spp and not calls,
              f"phase 25b: spp-sharded {name}: launches {launched}, plain {calls}")
        print(f"phase 25b: render_spp_sharded cornell {name} {width}x{width} {spp} spp depth "
              f"{depth} over [cuda:0] x 4, {spp // 4} batches: within rtol 1e-5 / atol 1e-6 of "
              f"the stratum loop (max abs err {err:.3e}), rays {rays} equal; {wall:.6f} s; "
              f"launches {launched} ({card})")
    w_rv, spp_rv, d_rv = DIST_REFVIS
    cfg = dataclasses.replace(cams["cornell"]("bdpt", ref_vis=True), image_width=w_rv,
                              samples_per_pixel=spp_rv, max_depth=d_rv)
    ref = render_mod.render(cornell, cfg, seed=0)
    (fb, _, st), launched, calls = drive(
        lambda: render_distributed(cornell, cfg, mesh=[dev] * 2, seed=0))
    check(np.array_equal(fb, ref.framebuffer_sum) and same_counts(st, ref.stats),
          "phase 25b: sharded ref_vis differs from render()")
    check(launched.get("closest_tri", 0) > 0 and launched.get("any_tri", 0) > 0 and not calls,
          f"phase 25b: sharded ref_vis: launches {launched}, plain {calls}")
    print(f"phase 25b: render_distributed cornell ref_vis bdpt {w_rv}x{w_rv} {spp_rv} spp depth "
          f"{d_rv} over [cuda:0] x 2: equal to render() with counters; {st.wall_seconds:.6f} s; "
          f"launches {launched} ({card})")
    lap("phase 25b")

    # ---- (c) two processes on the card, their shards gathered over gloo
    os.makedirs("output", exist_ok=True)
    for sname, integ, scene_arg in (("cornell", "bdpt", "cornell"), ("coffee", "pt", COFFEE_YAML)):
        ref = refs[(sname, integ)]
        out = os.path.abspath(f"output/chip_smoke_2proc_{sname}_{integ}.npy")
        t0 = time.monotonic()
        outs = launch_local(2, ["--scene", scene_arg, "--size", f"{width}x{width}", "--spp",
                                str(spp), "--max-depth", str(depth), "--integrator", integ,
                                "--seed", "0", "--output", out],
                            device="cuda", backend="gloo", timeout=300.0)
        t_all = time.monotonic() - t0
        fb = np.load(out)
        check(np.array_equal(fb, ref.framebuffer_sum),
              f"phase 25c: 2 processes, {sname} {integ}: the gathered image differs from render()")
        lines = [ln for o in outs for ln in o.splitlines() if ln.startswith("[worker ")
                 and "launches=" in ln]
        check(len(lines) == 2, f"phase 25c: {len(lines)} rank lines:\n{''.join(outs)[-2000:]}")
        for ln in lines:
            launched = json.loads(ln.split("launches=")[1].split(" plain_calls=")[0])
            calls = json.loads(ln.split("plain_calls=")[1])
            check(sum(launched.values()) > 0 and not calls,
                  f"phase 25c: a rank launched {launched}, plain {calls}")
            for k, n in launched.items():
                totals[k] = totals.get(k, 0) + n
            print(f"phase 25c: {ln} ({card})")
        print(f"phase 25c: launch_local(2, device='cuda', backend='gloo') {sname} {integ} "
              f"{width}x{width} {spp} spp depth {depth}: the gathered image equal to render()'s; "
              f"{t_all:.1f} s with the processes' start-up ({card})")
    lap("phase 25c")

    # ---- (d) render_resilient: one injected failure each, resumed
    def flaky(name, fail_at):
        orig = getattr(render_mod, name)
        calls = [0]

        def fn(*a, **k):
            calls[0] += 1
            if calls[0] == fail_at:
                raise RuntimeError(f"injected failure at call {fail_at} of {name}")
            return orig(*a, **k)
        return orig, fn, calls

    orig_batch = render_mod._wave_spp_batch
    for sname, integ, name, fail_at, kw in (
            ("cornell", "bdpt", "bdpt_megakernel_pixels", 3, dict(chunk_size=width * width // 4)),
            ("coffee", "pt", "pt_wave", 2, {})):
        orig, fn, calls = flaky(name, fail_at)
        setattr(render_mod, name, fn)
        if name == "pt_wave":
            render_mod._wave_spp_batch = lambda npix, spp_eff: 4
        try:
            res, launched, _ = drive(lambda: render_mod.render_resilient(
                scenes[sname], cams[sname](integ), seed=0, **kw))
        finally:
            setattr(render_mod, name, orig)
            render_mod._wave_spp_batch = orig_batch
        check(np.array_equal(res.framebuffer_sum, refs[(sname, integ)].framebuffer_sum),
              f"phase 25d: render_resilient {sname} {integ} differs from render()")
        check(calls[0] == 5, f"phase 25d: {name} called {calls[0]} times, not 4 units + 1")
        print(f"phase 25d: render_resilient {sname} {integ} ({name} failing at its call "
              f"{fail_at} of 4 units, {kw or 'batches of 4 strata'}): equal to render() to the "
              f"bit; launches {launched} ({card})")
    lap("phase 25d")
    return totals


# phase 26's shapes: the float64 coffee renders of the main path (integrator,
# width, spp; depth 10), the random rays of (a), the CLI's --f64 drives of
# (c) on the glass stand-in (PT, depth 80), the coffee stand-in (its BDPT
# default and PT, depth 24) and earth.yaml (BDPT, depth 8), and
# render_distributed's devices in (d)
F64_RENDERS = (("bdpt-mis", 512, 4), ("pt", 512, 4))
F64_RAYS = 65536
F64_CLI = (("scenes/glass/glass_standin.yaml", "--integrator", "pt", "--size", "160x90",
            "--spp", "4"),
           ("scenes/coffee/coffee_standin.yaml", "--size", "64x64", "--spp", "4"),
           ("scenes/coffee/coffee_standin.yaml", "--integrator", "pt", "--size", "64x64",
            "--spp", "4"),
           ("scenes/earth.yaml", "--size", "64x64", "--spp", "4"))
F64_MESH = 2
# the H100 SXM's published FP64 operations/s outside the tensor cores: the
# float64 walks' compares, min/max and divides do not run on them
FP64_OPS = 34e12


def bound64(nbytes: float, ops: float) -> tuple[float, str]:
    """``bound`` with FP64 operations."""
    b, o = nbytes / HBM_BPS * 1e3, ops / FP64_OPS * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def walk64_bytes(which, active_or_tmax) -> int:
    """Bytes a float64 walk call must move besides the scene.  closest_bvh:
    every lane reads its mask byte and tmin and writes t, tri, u, v; a live
    lane also reads tmax, its origin and direction.  any_bvh: every lane
    reads tmax and writes its answer byte; a live lane (tmax > 0) also
    reads tmin, its origin and direction."""
    if which == "closest":
        B, live = int(active_or_tmax.shape[0]), int(active_or_tmax.sum())
        return B * (1 + 8 + 3 * 8 + 4) + live * (8 + 6 * 8)
    B, live = int(active_or_tmax.shape[0]), int((active_or_tmax > 0).sum())
    return B * (8 + 1) + live * (8 + 6 * 8)


def f64_lanes(scene, B, seed):
    """B random rays in the scene's root box at f64 (a few with zero
    direction components, origins on a box plane: the NaN slab terms),
    per-lane tmin (half T_MIN, half in [-1, 1)) and tmax (half inf, half
    within the box's extent), NaN bounds, tmax 0 and -1, one lane in eight
    inactive: (o, d, tmin, tmax, active)."""
    import numpy as np
    import torch

    from bpt_tpu_torch.core.vec3 import Vec3

    g = np.random.default_rng(seed)
    lo, hi = (x.cpu().numpy() for x in (scene.bvh_min[0], scene.bvh_max[0]))
    o = g.uniform(lo, hi, (B, 3))
    d = g.normal(size=(B, 3))
    d[:8, 0] = 0.0
    o[:4, 0] = lo[0]
    tmin = np.where(g.uniform(size=B) < 0.5, 1e-3, g.uniform(-1.0, 1.0, B))
    tmax = np.where(g.uniform(size=B) < 0.5, np.inf, g.uniform(0.0, (hi - lo).max(), B))
    tmin[::89], tmax[::97], tmax[::53], tmax[::61] = np.nan, np.nan, 0.0, -1.0
    dev = scene.device

    def cuda(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return (Vec3(*(cuda(o[:, k]) for k in range(3))), Vec3(*(cuda(d[:, k]) for k in range(3))),
            cuda(tmin), cuda(tmax), cuda(g.uniform(size=B) > 0.125))


def bvh64_ptxas(lines) -> dict:
    """ptxas's registers and spill bytes of the float64 walk kernels
    bvh64<false> / bvh64<true> in the lines of a build's log (``-Xptxas
    -v``: the entry function's line, its function properties, its stack and
    spill line, its register line): {"closest": {...}, "any": {...}}."""
    import re

    out = {}
    for k, line in enumerate(lines):
        m = re.search(r"entry function '(_ZN3bpt5bvh64ILb([01])\S*)'", line)
        if not m:
            continue
        text = " ".join(lines[k + 1:k + 5])
        regs = re.search(r"Used (\d+) registers", text)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)
        out["any" if m.group(2) == "1" else "closest"] = dict(
            kernel=m.group(1), registers=int(regs.group(1)) if regs else None,
            spill_stores=int(spill.group(1)) if spill else None,
            spill_loads=int(spill.group(2)) if spill else None)
    return out


def bvh64_build_report() -> dict:
    """``bvh64_ptxas`` of this build's log, with each kernel's persistent
    grid (blocks of 128 threads)."""
    from bpt_tpu_torch.ops.kernels import build

    out = bvh64_ptxas(build.library_path().with_suffix(".log").read_text().splitlines())
    for which, r in out.items():
        r["grid"] = build.load_library().bpt_bvh_f64_blocks(int(which == "any"))
    return out


def walk64_table_bytes(scene) -> int:
    """The bytes of the float64 BVH that a walk must read, each once: a
    node's box and links (56 B) and a triangle's v0, e1, e2 (72 B).  The
    padding of walk_tables64's 64-byte records and 80-byte rows is left
    out of the bound."""
    return 56 * int(scene.bvh_min.shape[0]) + 72 * int(scene.num_tris)


def walk64_agree(kout, pout):
    """(lanes that differ in any bit of any output, max abs and max
    relative error of t, u, v over the lanes the plain version hits; inf
    equal to inf) of a float64 walk kernel's outputs against its plain
    version's."""
    if len(kout) == 2:
        return int((kout[0] != pout[0]).sum()), 0.0, 0.0
    hit = pout[1] >= 0
    same = kout[1] == pout[1]
    err = rel = 0.0
    for k, p in zip((kout[0], *kout[2:4]), (pout[0], *pout[2:4])):
        same &= (k == p) | (k.isnan() & p.isnan())
        if bool(hit.any()):
            e = (k - p).abs()[hit]
            err = max(err, float(e.max()))
            rel = max(rel, float((e / p.abs()[hit].clamp_min(1e-300)).max()))
    return int((~same).sum()), err, rel


def f64_phases(dev, card, lap) -> dict:
    """Phase 26, float64 on scenes with a BVH: the stratum loop over the
    float64 instantiations of closest_bvh / any_bvh.  (b) The main path:
    render() of the coffee stand-in in float64 with bdpt-mis and pt at
    512x512, 4 spp, depth 10, one warm-up and three timed renders each:
    the stratum route, the float64 walk kernels launched and nothing else,
    no plain version, images finite, not black and bitwise repeatable,
    rays_traced within 0.1% of the float32 stratum loop on the same jnp
    stream (the megakernels refused, the float32 walks), peak device
    memory.  (a) closest_bvh / any_bvh in float64 against their plain
    versions on 65,536 random coffee rays with per-lane intervals (NaN, 0
    and negative bounds) and inactive lanes, on every 16th lane of the
    bdpt-mis render's camera bounce 1 and on every 160th lane of its
    shadow wave of camera vertex 1 (each slice equal to the whole launch
    on those lanes): hit, tri and all four counters exact, t, u, v within
    1e-12 relative, the lanes that differ in any bit printed; the kernels
    timed at camera bounce 1 and that shadow wave, the plain versions on
    the random rays and the slices.  (c) The CLI's --f64 on the glass
    stand-in (its BVH over 510 triangles) at 160x90, 4 spp, depth 80, PT,
    on the coffee stand-in at 64x64, 4 spp, with its BDPT default and
    with PT, and on earth.yaml at 64x64, 4 spp, BDPT: exit 0, the float64
    walks launched and no other kernel, no plain call.
    (d) render_distributed of the float64 coffee PT render over [cuda:0]
    x 2: image and counters equal to render()'s to the bit.  Returns the
    kernels line's float64 entries."""
    import numpy as np
    import torch

    from bpt_tpu_torch import render as cli
    from bpt_tpu_torch.core.vec3 import Vec3
    from bpt_tpu_torch.models import render as render_mod
    from bpt_tpu_torch.models.camera import camera_constants
    from bpt_tpu_torch.models.render import render
    from bpt_tpu_torch.ops.kernels import pt_kernel as pk
    from bpt_tpu_torch.ops.kernels import pt_wave as pw
    from bpt_tpu_torch.parallel import render_distributed
    from bpt_tpu_torch.parallel.worker import launch_counts

    def drive(fn):
        """fn() with every count at 0 before it: (its result, launches,
        plain calls, float64 launches of closest_bvh and any_bvh)."""
        zero_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        launched, calls = launch_counts()
        return out, launched, calls, [pw.closest_bvh.f64_launches, pw.any_bvh.f64_launches]

    coffee32 = coffee_builder().build(device=dev)
    coffee = coffee_builder().build(device=dev, dtype=torch.float64)
    table_bytes = walk64_table_bytes(coffee)
    print(f"phase 26: the float64 coffee stand-in: walk tables {table_bytes} bytes of "
          f"boxes, links and triangles "
          f"({sum(t.numel() * t.element_size() for t in pw.walk_tables64(coffee))} allocated) "
          f"(float32 {sum(t.numel() * t.element_size() for t in pw.walk_tables(coffee32))}); "
          f"walk_reject_reason {pw.walk_reject_reason(coffee)!r}")
    with torch.cuda.device(dev):
        report = bvh64_build_report()
    for which, r in report.items():
        print(f"phase 26: bvh64 {which} ({r['kernel']}): {r['registers']} registers, spill "
              f"stores {r['spill_stores']} B, loads {r['spill_loads']} B, persistent grid "
              f"{r['grid']} blocks of 128 threads ({card})")
    check(set(report) == {"closest", "any"}
          and all(None not in r.values() and r["grid"] > 0 for r in report.values()),
          f"phase 26: the float64 walks' build report is incomplete: {report}")

    # ---- (b) the float64 main path through render()
    out = {"renders": {}}
    f64_launched = [0, 0]
    for integ, width, spp in F64_RENDERS:
        cfg = coffee_camera(width=width, spp=spp, integrator=integ)
        route = render_mod._route(coffee, cfg, integ, None)
        check(route == "strata", f"phase 26b: float64 coffee {integ} takes route {route}")
        torch.cuda.reset_peak_memory_stats()
        with capture(pw, "closest_bvh", keep={1}) as cam1, capture(pw, "any_bvh",
                                                                   keep={1}) as shadow:
            warm = render(coffee, cfg, seed=0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        if integ == "bdpt-mis":
            out["camera1"], out["shadow1"] = cam1[1], shadow[1]  # (args, kwargs)
        runs, launched, calls, n64 = drive(lambda: [render(coffee, cfg, seed=0)
                                                    for _ in range(3)])
        f64_launched = [a + b for a, b in zip(f64_launched, n64)]
        walls = [r.stats.wall_seconds for r in runs]
        fb, st = warm.framebuffer_sum, warm.stats
        check(all(np.array_equal(r.framebuffer_sum, fb) for r in runs)
              and all(r.stats.rays_traced == st.rays_traced for r in runs),
              f"phase 26b: float64 coffee {integ} renders differ")
        check(bool(np.isfinite(fb).all()) and float(fb.mean()) > 0.0,
              f"phase 26b: float64 coffee {integ} image not finite or black")
        want = {"closest_bvh": n64[0]} | ({"any_bvh": n64[1]} if integ != "pt" else {})
        check(launched == want and n64[0] > 0 and (n64[1] > 0) == (integ != "pt")
              and not calls,
              f"phase 26b: float64 coffee {integ}: launches {launched}, float64 {n64}, "
              f"plain {calls}")
        # the float32 stratum loop on the same jnp stream: the megakernels refused
        cc = camera_constants(cfg, torch.float32, dev)
        fb32 = torch.zeros((width * width, 3), device=dev)
        refuse = pk.megakernel_reject_reason
        pk.megakernel_reject_reason = lambda *a, **kw: "phase 26: the jnp stream in float32"
        try:
            rays32 = int(render_mod._render_strata(coffee32, cfg, cc, integ, 0, fb32, None,
                                                   None, None)[0])
        finally:
            pk.megakernel_reject_reason = refuse
        gap = (st.rays_traced - rays32) / rays32 * 100
        out["renders"][integ] = dict(walls=walls, rays=st.rays_traced, shadow=st.shadow_rays,
                                     rays32=rays32, peak_gib=peak, launches=launched)
        budget = ""
        if integ != "pt":
            strata, span = render_mod._bdpt_wave_shape(width * width, spp, 10,
                                                       integ == "bdpt-mis", torch.float64)
            a, b, c = render_mod.BYTES_PER_RAY[torch.float64][integ == "bdpt-mis"]
            budget = (f"; waves of {strata} strata x {span} pixels, budgeted "
                      f"{strata * span * (a * 100 + b * 10 + c) / 2**30:.2f} GiB, peak "
                      f"{peak * 2**30 / render_mod.BDPT_WAVE_BYTES * 100:.1f}% of "
                      f"BDPT_WAVE_BYTES ({render_mod.BDPT_WAVE_BYTES / 2**30:.0f} GiB)")
        if integ == "pt":
            out["pt_ref"] = warm
        print(f"phase 26b: render coffee float64 {integ} {width}x{width} {spp} spp depth 10 "
              f"seed 0 (the stratum loop): walls {[round(w, 6) for w in walls]} s, median "
              f"{statistics.median(walls):.6f} s, {st.rays_traced / statistics.median(walls) / 1e6:.2f} "
              f"Mrays/s; rays {st.rays_traced}, shadow {st.shadow_rays}; float32 on the same "
              f"stream {rays32} rays ({gap:+.4f}%); three renders' launches {launched}, float64 "
              f"{n64}, plain calls {calls}; images bitwise repeatable; peak device memory "
              f"{peak:.2f} GiB{budget} ({card})")
        check(abs(gap) <= 0.1, f"phase 26b: float64 coffee {integ} rays {st.rays_traced} not "
              f"within 0.1% of float32's {rays32}")
        del runs, warm, fb32
    lap("phase 26b")

    # ---- (a) the float64 kernels against their plain versions
    o, d, tmin, tmax, act = f64_lanes(coffee, F64_RAYS, 26)
    kc = pw.closest_bvh(coffee, o, d, act, tmin, tmax)
    pc, c_plain_ms = timed(lambda: pw.closest_bvh_plain(coffee, o, d, act, tmin, tmax))
    c_diff, c_err, c_rel = walk64_agree(kc, pc)
    tm = torch.where(act, tmax, 0.0)
    ka = pw.any_bvh(coffee, o, d, tm, tmin)
    pa, a_plain_ms = timed(lambda: pw.any_bvh_plain(coffee, o, d, tm, tmin))
    a_diff = walk64_agree(ka, pa)[0]
    print(f"phase 26a: float64 closest_bvh on {F64_RAYS} random coffee rays with per-lane "
          f"[tmin, tmax], {int(act.sum())} active: {c_diff} lanes differ in any bit from the "
          f"plain walk, t/u/v max abs error {c_err:.3e}, relative {c_rel:.3e}, "
          f"{int((kc[1] >= 0).sum())} hits, "
          f"counters kernel {kc[4].tolist()} plain {pc[4].tolist()}; plain {c_plain_ms:.3f} ms")
    print(f"phase 26a: float64 any_bvh on the same rays: {a_diff} lanes differ, "
          f"{int(ka[0].sum())} hits, counters kernel {ka[1].tolist()} plain {pa[1].tolist()}; "
          f"plain {a_plain_ms:.3f} ms")
    check(bool((kc[1] == pc[1]).all()) and c_rel <= 1e-12 and kc[4].tolist() == pc[4].tolist(),
          "phase 26a: float64 closest_bvh differs from its plain version")
    check(a_diff == 0 and ka[1].tolist() == pa[1].tolist(),
          "phase 26a: float64 any_bvh differs from its plain version")
    # the main path's own shapes: camera bounce 1 and the shadow wave
    _, o1, d1, act1, tmin1, tmax1 = out["camera1"][0]
    Bc = int(act1.shape[0])
    k1 = pw.closest_bvh(coffee, o1, d1, act1, tmin1, tmax1)
    c_ms = time_ms(lambda: pw.closest_bvh(coffee, o1, d1, act1, tmin1, tmax1), reps=5)
    c_bound = bound64(walk64_bytes("closest", act1) + table_bytes,
                      int(k1[4][0]) * SLAB_OPS + int(k1[4][2]) * MT_OPS)

    def every(x, n):  # every n-th lane of a lane array; a number stays
        return x[::n].contiguous() if isinstance(x, torch.Tensor) else x

    args_c = (Vec3(*(every(c, 16) for c in o1)), Vec3(*(every(c, 16) for c in d1)),
              every(act1, 16), every(tmin1, 16), every(tmax1, 16))
    kcs = pw.closest_bvh(coffee, *args_c)
    pcs, c1_plain_ms = timed(lambda: pw.closest_bvh_plain(coffee, *args_c))
    c1_diff, c1_err, _ = walk64_agree(kcs, pcs)
    print(f"phase 26a: float64 closest_bvh on every 16th lane of camera bounce 1 "
          f"({int(args_c[2].numel())} lanes, {int(args_c[2].sum())} live): {c1_diff} lanes "
          f"differ in any bit from the plain walk, t/u/v max abs error {c1_err:.3e}, counters "
          f"kernel {kcs[4].tolist()} plain {pcs[4].tolist()}, plain {c1_plain_ms:.3f} ms")
    check(c1_diff == 0 and kcs[4].tolist() == pcs[4].tolist()
          and all(torch.equal(a, b[::16]) for a, b in zip(kcs[:4], k1[:4])),
          "phase 26a: float64 closest_bvh at camera bounce 1 differs from its plain version")
    _, os_, ds_, tms, tmins = out["shadow1"][0]
    Bs = int(tms.shape[0])
    ks = pw.any_bvh(coffee, os_, ds_, tms, tmins)
    a_ms = time_ms(lambda: pw.any_bvh(coffee, os_, ds_, tms, tmins), reps=5)
    a_bound = bound64(walk64_bytes("any", tms) + table_bytes,
                      int(ks[1][0]) * SLAB_OPS + int(ks[1][2]) * MT_OPS)
    sl = slice(None, None, 160)
    args_s = (Vec3(*(every(c, 160) for c in os_)), Vec3(*(every(c, 160) for c in ds_)),
              every(tms, 160), every(tmins, 160))
    kss = pw.any_bvh(coffee, *args_s)
    pss, s_plain_ms = timed(lambda: pw.any_bvh_plain(coffee, *args_s))
    s_diff = walk64_agree(kss, pss)[0]
    print(f"phase 26a: float64 closest_bvh at camera bounce 1 of the bdpt-mis render (B={Bc}, "
          f"{int(act1.sum())} live): {c_ms:.3f} ms, bound {c_bound[0]:.4f} ms ({c_bound[1]}), "
          f"counters {k1[4].tolist()}; any_bvh at its shadow wave of camera vertex 1 (B={Bs}, "
          f"{int((tms > 0).sum())} live): {a_ms:.3f} ms, bound {a_bound[0]:.4f} ms "
          f"({a_bound[1]}), counters {ks[1].tolist()}; on every 160th lane of that wave "
          f"({int(tms[sl].numel())} lanes): {s_diff} lanes differ from the plain walk, counters "
          f"kernel {kss[1].tolist()} plain {pss[1].tolist()}, plain {s_plain_ms:.3f} ms ({card})")
    check(s_diff == 0 and kss[1].tolist() == pss[1].tolist()
          and torch.equal(kss[0], ks[0][sl]),
          "phase 26a: float64 any_bvh on the shadow wave differs from its plain version")
    out["closest"] = dict(err=max(c_err, c1_err), diff=c_diff + c1_diff, ms=c_ms,
                          plain_ms=c_plain_ms, bound=c_bound, B=Bc, live=int(act1.sum()),
                          slice_plain_ms=c1_plain_ms)
    out["any"] = dict(err=0.0, diff=a_diff + s_diff, ms=a_ms, plain_ms=a_plain_ms,
                      bound=a_bound, B=Bs, live=int((tms > 0).sum()),
                      slice_plain_ms=s_plain_ms)
    out["f64_launches"] = f64_launched
    out["build"] = report
    del out["camera1"], out["shadow1"], kc, pc, ka, pa, k1, ks, kcs, pcs
    lap("phase 26a")

    # ---- (c) the CLI's --f64 on the glass, coffee and earth scenes
    for k, drive_args in enumerate(F64_CLI):
        argv = [*drive_args, "--f64", "--output", f"chip_smoke_f64_cli{k}.png", "--no-progress"]
        t0 = time.monotonic()
        rc, launched, calls, n64 = drive(lambda: cli.main(argv))
        want = {"closest_bvh": n64[0]} | ({"any_bvh": n64[1]} if "pt" not in argv else {})
        print(f"phase 26c: python -m bpt_tpu_torch.render {' '.join(argv)}: exit {rc} in "
              f"{time.monotonic() - t0:.1f} s; launches {launched}, float64 {n64}, plain calls "
              f"{calls} ({card})")
        check(rc == 0 and launched == want and all(n > 0 for n in want.values())
              and not calls,
              f"phase 26c: --f64 on {drive_args[0]} did not render through the float64 walks")
    lap("phase 26c")

    # ---- (d) render_distributed in float64
    ref = out.pop("pt_ref")
    cfg = coffee_camera(width=F64_RENDERS[1][1], spp=F64_RENDERS[1][2], integrator="pt")
    (fb, _, st), launched, calls, n64 = drive(
        lambda: render_distributed(coffee, cfg, mesh=[dev] * F64_MESH, seed=0))
    same = np.array_equal(fb, ref.framebuffer_sum) and dataclasses.replace(
        st, wall_seconds=0) == dataclasses.replace(ref.stats, wall_seconds=0)
    print(f"phase 26d: render_distributed of the float64 coffee PT render over [cuda:0] x "
          f"{F64_MESH}: image and counters {'equal' if same else 'NOT equal'} to render()'s "
          f"(rays {st.rays_traced}); wall {st.wall_seconds:.6f} s; launches {launched}, "
          f"float64 {n64}, plain calls {calls} ({card})")
    check(same and n64[0] > 0 and not calls,
          "phase 26d: render_distributed in float64 differs from render()")
    lap("phase 26d")
    return out


def f64_entries(f64) -> list:
    """The kernels line's entries of the float64 walk kernels (phase 26)."""
    main = "three coffee float64 renders each of " + " and ".join(
        f"{i} {w}x{w} x {s} spp" for i, w, s in F64_RENDERS) + ", depth 10 (the stratum loop)"
    rows = []
    for k, (name, tpu, jnp_fn) in enumerate((
            ("closest_bvh", "cluster_wave.py:340", "bpt_tpu/ops/soa.py:135 bvh_closest"),
            ("any_bvh", "cluster_wave.py:397", "bpt_tpu/ops/soa.py:240 bvh_any"))):
        r = f64[name.split("_")[0]]
        rows.append({
            "name": f"{name}_f64",
            "route": "cuda",
            "source": "bpt_tpu_torch/csrc/pt_wave.cu",
            "replaces": f"bpt_tpu/ops/pallas/{tpu} (its float64 counterpart: bpt_tpu runs "
                        f"{jnp_fn} for every float64 hit)",
            "launches": f64["f64_launches"][k],
            "launches_path": main,
            "max_abs_err": r["err"],
            "lanes_differing": r["diff"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "plain_shape": f"{F64_RAYS} random coffee rays, per-lane intervals",
            "slice_plain_ms": r["slice_plain_ms"],
            "slice_shape": ("every 16th lane of camera bounce 1" if name == "closest_bvh" else
                            "every 160th lane of the shadow wave of camera vertex 1"),
            "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1],
            "library_ms": None,
            "shape": (f"camera bounce 1 of the float64 bdpt-mis render, B={r['B']}"
                      if name == "closest_bvh" else
                      f"the float64 bdpt-mis render's shadow wave of camera vertex 1, "
                      f"B={r['B']}"),
            "live": r["live"],
            "registers": f64["build"][name.split("_")[0]]["registers"],
            "spill_bytes": [f64["build"][name.split("_")[0]][k]
                            for k in ("spill_stores", "spill_loads")],
            "grid_blocks": f64["build"][name.split("_")[0]]["grid"],
            "render_walls_s": {i: v["walls"] for i, v in f64["renders"].items()},
            "render_rays": {i: v["rays"] for i, v in f64["renders"].items()},
            "render_rays_float32": {i: v["rays32"] for i, v in f64["renders"].items()},
            "render_peak_gib": {i: v["peak_gib"] for i, v in f64["renders"].items()},
        })
    return rows


# phase 27's shapes: the north-star's image, strata and depth
# (tools/torch_northstar.py renders it at 1024 spp); its renders here take
# 1 spp; the lanes held against the plain versions are the image's last
# NS_PIXELS pixels at strata NS_STRATA, the last stratum range a 2^18-pixel
# chunk of it launches (pt_kernel.stratum_ranges)
NS_SIZE, NS_SQRT_SPP, NS_DEPTH = (1920, 1080), 32, 80
NS_PIXELS, NS_STRATA = 32, (1020, 1024)


@contextlib.contextmanager
def strata_only(k0: int, k1: int):
    """The pixels-mode wrappers' launch plan (``walk_launches``) cut to the
    strata [k0, k1): one kernel launch over them, then one ``strata_sum``
    from zeros, as a call's first range is summed."""
    import torch

    from bpt_tpu_torch.ops.kernels import bdpt_kernel as bk
    from bpt_tpu_torch.ops.kernels import pt_kernel as pk

    def plan(B, pixels, spp, launch, dev):
        rows = torch.empty((3, k1 - k0, B), dtype=torch.float32, device=dev)
        launch(k0, k1 - k0, rows)
        return pk.strata_sum(rows, torch.empty((3, B), dtype=torch.float32, device=dev),
                             first=True)

    saved = pk.walk_launches, bk.walk_launches
    pk.walk_launches = bk.walk_launches = plan
    try:
        yield
    finally:
        pk.walk_launches, bk.walk_launches = saved


def northstar_phase(dev, card, lap) -> dict:
    """Phase 27, the north-star on the card (tools/torch_northstar.py runs
    it at 1024 spp).  (a) The glass stand-in (510 triangles) at 1920x1080,
    1 spp, depth 80, seed 0, with pt, bdpt and bdpt-mis through render(),
    every count 0 before each: route "fused", megakernel_reject_reason
    empty, 8 pixels-mode launches (default_chunk_size's 2^18-pixel chunks,
    the last one 238,592 pixels), no other kernel and no plain version, the
    image finite and not black, rays > 0; walls printed.  (b) The image's
    last 32 pixels at strata [1020, 1024) of 1024 spp, depth 80 (sample ids
    up to 2,123,366,399): pt_megakernel_pixels and bdpt_megakernel_pixels
    (bdpt, bdpt-mis) launched on that range alone (strata_only), against
    their plain versions over the same four samples, one call with a sample
    a lane (PT: the plain pixels mode; BDPT: bdpt_kernel.stratum_plain),
    summed in stratum order, which sweep the scene's triangles as the
    brute-force kernels do (the scene's BVH dropped), so that every counter
    counts the same: radiance within rtol 1e-4 / atol 1e-6 (PT) or 1e-5
    (BDPT) on >= 99.9% of lanes, counters exact.  Returns the launches of
    (a) and the worst error of (b) by kernel."""
    import numpy as np
    import torch

    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.models import render as render_mod
    from bpt_tpu_torch.models.camera import camera_constants
    from bpt_tpu_torch.ops.kernels import bdpt_kernel as bk
    from bpt_tpu_torch.ops.kernels import pt_kernel as pk
    from bpt_tpu_torch.parallel.worker import launch_counts
    from bpt_tpu_torch.scene.loader import load_scene_from_yaml

    loaded = load_scene_from_yaml("scenes/glass/glass_standin.yaml", device=dev, verbose=False)
    scene = loaded.scene
    W, H = NS_SIZE
    npix = W * H
    chunk = render_mod.default_chunk_size(npix)
    n_chunks = -(-npix // chunk)
    check((chunk, n_chunks, npix - (n_chunks - 1) * chunk) == (1 << 18, 8, 238_592),
          f"phase 27: the north-star's chunks are {chunk} x {n_chunks}")
    out = {"launches": {}, "err": {}, "walls": {}}
    for integ in ("pt", "bdpt", "bdpt-mis"):
        cfg = dataclasses.replace(loaded.camera, image_width=W, aspect_ratio=W / H,
                                  samples_per_pixel=1, max_depth=NS_DEPTH, integrator=integ)
        reason = pk.megakernel_reject_reason(scene, integ)
        route = render_mod._route(scene, cfg, integ, None)
        check(reason == "" and route == "fused" and cfg.image_height == H,
              f"phase 27a: glass {integ}: reason {reason!r}, route {route}")
        zero_launch_counts()
        res = render_mod.render(scene, cfg, seed=0)
        launched, calls = launch_counts()
        name = "pt_megakernel_pixels" if integ == "pt" else "bdpt_megakernel_pixels"
        fb, st = res.framebuffer_sum, res.stats
        check(launched == {name: n_chunks} and not calls,
              f"phase 27a: glass {integ}: launches {launched}, plain calls {calls}")
        check(bool(np.isfinite(fb).all()) and float(fb.mean()) > 0.0 and st.rays_traced > 0
              and (st.shadow_rays > 0) == (integ != "pt"),
              f"phase 27a: glass {integ} image not finite, black or without rays")
        out["launches"][integ] = launched[name]
        out["walls"][integ] = st.wall_seconds
        print(f"phase 27a: render glass {integ} {W}x{H} 1 spp depth {NS_DEPTH} seed 0 (route "
              f"{route}, {n_chunks} chunks of {chunk} pixels, the last {npix - 7 * chunk}): wall "
              f"{st.wall_seconds:.6f} s, rays {st.rays_traced}, shadow {st.shadow_rays}, "
              f"{st.rays_traced / st.wall_seconds / 1e6:.2f} Mrays/s; launches {launched}, "
              f"plain calls {calls} ({card})")
    lap("phase 27a")

    # ---- (b) the largest sample ids against the plain versions
    spp = NS_SQRT_SPP ** 2
    cfg = dataclasses.replace(loaded.camera, image_width=W, aspect_ratio=W / H,
                              samples_per_pixel=spp, max_depth=NS_DEPTH)
    cam = pk.camera_table(camera_constants(cfg, torch.float32, dev))
    plain_scene = dataclasses.replace(scene, use_bvh=False)
    key = rng.prng_key(0)
    pix = torch.arange(npix - NS_PIXELS, npix, dtype=torch.int32, device=dev)
    i, j = (pix % W).float(), (pix // W).float()
    strata = range(*NS_STRATA)
    check(int(pix[-1]) * spp + strata[-1] == 2_123_366_399 < 2**31,
          "phase 27b: the north-star's last sample id")
    for integ in ("pt", "bdpt", "bdpt-mis"):
        t0 = time.monotonic()
        mis = integ == "bdpt-mis"
        if integ == "pt":
            mk = pk.pt_megakernel_pixels
            args = (scene, i, j, i * 0, j * 0, pix, cam, key, NS_DEPTH)
            kw = dict(spp_loop=spp, sqrt_spp=NS_SQRT_SPP)
        else:
            mk = bk.bdpt_megakernel_pixels
            args = (scene, i, j, pix, cam, key, NS_DEPTH, NS_SQRT_SPP)
            kw = dict(mis=mis)
        n = mk.launches, pk.strata_sum.launches
        with strata_only(*NS_STRATA):
            kout = mk(*args, **kw)
        torch.cuda.synchronize()
        launched = (mk.launches - n[0], pk.strata_sum.launches - n[1])
        # the plain versions take the four strata as lanes, stratum-major
        k = torch.arange(*NS_STRATA, device=dev).repeat_interleave(NS_PIXELS)
        p4, i4, j4 = pix.repeat(len(strata)), i.repeat(len(strata)), j.repeat(len(strata))
        if integ == "pt":
            r = pk.pt_megakernel_pixels_plain(
                plain_scene, i4, j4, (k % NS_SQRT_SPP).float(), (k // NS_SQRT_SPP).float(),
                p4.long() * spp + k, cam, key, NS_DEPTH)
            rad, counts = torch.stack(r[:3], 1), [r[3], *r[4]]
        else:
            rad, rays, shadow, extra = bk.stratum_plain(plain_scene, i4, j4, p4, cam, key,
                                                        NS_DEPTH, NS_SQRT_SPP, k, mis)
            counts = [rays, shadow, *extra]
        rad = rad.reshape(len(strata), NS_PIXELS, 3)
        total = rad[0]
        for r_s in rad[1:]:  # stratum order, as strata_sum adds them
            total = total + r_s
        pout = (*total.unbind(1), *counts[:-4], torch.stack(counts[-4:]))
        atol = ATOL if integ == "pt" else BDPT_ATOL
        f, e = compare(f"phase 27b: {mk.__name__} {integ}, the last {NS_PIXELS} pixels at "
                       f"strata [{NS_STRATA[0]}, {NS_STRATA[1]}) of {spp}, depth {NS_DEPTH}",
                       kout, pout, exact_counts=True, atol=atol)
        check(launched == (1, 1), f"phase 27b: {integ} launched {launched}, not (1, 1)")
        out["err"][integ] = e
        print(f"phase 27b: {integ}: one launch of strata [{NS_STRATA[0]}, {NS_STRATA[1]}) and "
              f"one strata_sum; {time.monotonic() - t0:.1f} s ({card})")
    lap("phase 27b")
    return out


def northstar_keys(ns27, *integrators) -> dict:
    """A pixels-mode kernel's entries of phase 27 in the kernels line."""
    return {
        "northstar_launches": sum(ns27["launches"][i] for i in integrators),
        "northstar_launches_path": f"{' and '.join(integrators)} renders of the glass stand-in, "
                                   f"{NS_SIZE[0]}x{NS_SIZE[1]}, 1 spp, depth {NS_DEPTH} "
                                   "(phase 27a)",
        "northstar_max_abs_err": max(ns27["err"][i] for i in integrators),
        "northstar_shape": f"the last {NS_PIXELS} pixels of the {NS_SIZE[0]}x{NS_SIZE[1]} "
                           f"image at strata [{NS_STRATA[0]}, {NS_STRATA[1]}) of "
                           f"{NS_SQRT_SPP ** 2}, depth {NS_DEPTH} (phase 27b)",
    }


class Laps:
    """Prints the seconds since the previous lap."""

    def __init__(self):
        self.t = time.monotonic()

    def __call__(self, name):
        now = time.monotonic()
        print(f"{name} took {now - self.t:.1f} s")
        self.t = now


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs an NVIDIA card", file=sys.stderr)
        return 1

    from bpt_tpu_torch.core import rng
    from bpt_tpu_torch.core.vec3 import Vec3
    from bpt_tpu_torch.models.camera import camera_constants
    from bpt_tpu_torch.models.pt import NU
    from bpt_tpu_torch.models.render import render
    from bpt_tpu_torch.ops.kernels import bdpt_kernel as bk
    from bpt_tpu_torch.ops.kernels import build
    from bpt_tpu_torch.ops.kernels import pt_kernel as pk
    from bpt_tpu_torch.scene import builder
    from bpt_tpu_torch.scene.presets import (
        cornell_box,
        cornell_box_builder,
        cornell_box_camera,
    )
    from bpt_tpu_torch.utils.png import write_png

    t_start = time.monotonic()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    lap = Laps()
    refs = {}  # render() of phase 25's configurations, from phases 3, 8 and 10
    # ---- phase 1: build
    t0 = time.monotonic()
    lib_path = build.build()
    build.load_library()
    print(f"phase 1: built {lib_path.name} in {time.monotonic() - t0:.2f} s")
    log = lib_path.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                print("  ptxas:", line.strip())
    lap("phase 1")

    scene = cornell_box(device=dev)

    # ---- phase 2: kernel vs plain version on the card
    B, depth = 65536, 10
    g = np.random.default_rng(0)
    o = torch.from_numpy(g.uniform(50, 500, (B, 3)).astype(np.float32)).to(dev)
    d = torch.from_numpy(g.normal(size=(B, 3)).astype(np.float32)).to(dev)
    ov, dv = Vec3(*o.unbind(1)), Vec3(*d.unbind(1))
    ids = torch.arange(B, dtype=torch.int32, device=dev)
    ubuf = torch.from_numpy(
        g.uniform(size=(depth * NU, B)).astype(np.float32)).to(dev)
    key = rng.prng_key(0)
    for mode, u in (("buffer", ubuf), ("rng", None)):
        kout = pk.pt_megakernel(scene, ov, dv, ids, key, depth, uniforms=u)
        pout = pk.pt_megakernel_plain(scene, ov, dv, ids, key, depth, uniforms=u)
        torch.cuda.synchronize()
        compare(f"phase 2: pt_megakernel {mode} mode B={B} depth={depth}",
                kout, pout, exact_counts=False)
    pt_rays_tests = counters(kout)[3]  # RNG mode, the timed call below
    rays_ms = time_ms(lambda: pk.pt_megakernel(scene, ov, dv, ids, key, depth),
                      reps=10)
    rays_plain_ms = time_ms(lambda: pk.pt_megakernel_plain(
        scene, ov, dv, ids, key, depth), reps=3)
    print(f"phase 2: pt_megakernel rng mode B={B} depth={depth}: kernel "
          f"{rays_ms:.3f} ms, plain {rays_plain_ms:.3f} ms ({card})")

    def pixel_args(width, S=4):
        """(i, j, pixel ids, camera table) of a one-chunk render of a
        width x width image, built as models/render.py builds them."""
        cfg = dataclasses.replace(cornell_box_camera(), image_width=width,
                                  samples_per_pixel=S * S)
        cam = pk.camera_table(camera_constants(cfg, torch.float32, dev))
        pix = torch.arange(width * width, dtype=torch.int64, device=dev)
        return (pix % width).float(), (pix // width).float(), pix, cam

    S = 4
    for W in (64, 512):  # 512x512: the main path's chunk, 2^18 pixels
        i, j, pix, cam = pixel_args(W)
        args = (scene, i, j, i * 0, j * 0, pix, cam, key, depth)
        kout = pk.pt_megakernel_pixels(*args, spp_loop=S * S, sqrt_spp=S)
        pout = pk.pt_megakernel_pixels_plain(*args, spp_loop=S * S, sqrt_spp=S)
        torch.cuda.synchronize()
        frac, max_err = compare(
            f"phase 2: pt_megakernel_pixels {W}x{W} spp={S * S} depth={depth}",
            kout, pout, exact_counts=True)
        pt_tests = counters(kout)[3]
        del kout, pout
    ms = time_ms(lambda: pk.pt_megakernel_pixels(*args, spp_loop=S * S,
                                                 sqrt_spp=S), reps=5)
    plain_ms = time_ms(lambda: pk.pt_megakernel_pixels_plain(
        *args, spp_loop=S * S, sqrt_spp=S), reps=2)
    print(f"phase 2: pt_megakernel_pixels at {W}x{W} x {S * S} spp, depth "
          f"{depth}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms ({card})")
    lap("phase 2 (PT)")

    # ---- phase 2, BDPT: bdpt_megakernel vs its plain version
    # the mixed-material scene of tests/torch_parity.py::mixed_scene
    mixed = mixed_scene(dev)
    n_slots = bk.n_uniform_slots(depth)
    bdpt_err, bdpt_frac = 0.0, 1.0
    for sc_name, sc, nb in (("cornell", scene, B), ("mixed", mixed, 16384)):
        ovb, dvb = Vec3(*(x[:nb] for x in ov)), Vec3(*(x[:nb] for x in dv))
        ub = torch.from_numpy(g.uniform(size=(n_slots, nb)).astype(np.float32)).to(dev)
        for mis in (False, True):
            for mode, u in (("buffer", ub), ("rng", None)):
                a = (sc, ovb, dvb, ids[:nb], key, depth)
                kout = bk.bdpt_megakernel(*a, uniforms=u, mis=mis)
                pout = bk.bdpt_megakernel_plain(*a, uniforms=u, mis=mis)
                torch.cuda.synchronize()
                f, e = compare(f"phase 2: bdpt_megakernel {'bdpt-mis' if mis else 'bdpt'} "
                               f"{mode} mode {sc_name} B={nb} depth={depth}",
                               kout, pout, exact_counts=False, atol=BDPT_ATOL)
                bdpt_err, bdpt_frac = max(bdpt_err, e), min(bdpt_frac, f)
                if (sc_name, mis, mode) == ("cornell", False, "rng"):
                    bdpt_rays_tests = counters(kout)[4]  # the timed call below
    a = (scene, ov, dv, ids, key, depth)
    bdpt_rays_ms = time_ms(lambda: bk.bdpt_megakernel(*a), reps=5)
    bdpt_rays_plain_ms = time_ms(lambda: bk.bdpt_megakernel_plain(*a), reps=2)
    print(f"phase 2: bdpt_megakernel rng mode B={B} depth={depth}: kernel "
          f"{bdpt_rays_ms:.3f} ms, plain {bdpt_rays_plain_ms:.3f} ms ({card})")

    S = 4
    i, j, pix, cam = pixel_args(512)
    bdpt_ms, bdpt_plain_ms = {}, {}
    for name in ("bdpt", "bdpt-mis"):
        a = (scene, i, j, pix, cam, key, depth, S)
        mis = name == "bdpt-mis"
        kout = bk.bdpt_megakernel_pixels(*a, mis=mis)
        torch.cuda.reset_peak_memory_stats(dev)
        pout, bdpt_plain_ms[name] = timed(
            lambda: bk.bdpt_megakernel_pixels_plain(*a, mis=mis))
        plain_peak = torch.cuda.max_memory_allocated(dev)
        f, e = compare(f"phase 2: bdpt_megakernel_pixels {name} 512x512 spp={S * S} "
                       f"depth={depth}", kout, pout, exact_counts=True, atol=BDPT_ATOL)
        bdpt_err, bdpt_frac = max(bdpt_err, e), min(bdpt_frac, f)
        if name == "bdpt":
            bdpt_tests = counters(kout)[4]
        del kout, pout
        bdpt_ms[name] = time_ms(lambda: bk.bdpt_megakernel_pixels(*a, mis=mis), reps=5)
        print(f"phase 2: bdpt_megakernel_pixels {name} at 512x512 x {S * S} spp, "
              f"depth {depth}: kernel {bdpt_ms[name]:.3f} ms, plain "
              f"{bdpt_plain_ms[name]:.3f} ms (one call, peak device memory "
              f"{plain_peak / 2**30:.2f} GiB) ({card})")
    i, j, pix, cam = pixel_args(64, 2)
    a = (mixed, i, j, pix, cam, key, 80, 2)
    kout = bk.bdpt_megakernel_pixels(*a, mis=True)
    pout = bk.bdpt_megakernel_pixels_plain(*a, mis=True)
    f, e = compare("phase 2: bdpt_megakernel_pixels bdpt-mis mixed 64x64 spp=4 depth=80",
                   kout, pout, exact_counts=True, atol=BDPT_ATOL)
    bdpt_err, bdpt_frac = max(bdpt_err, e), min(bdpt_frac, f)
    del kout, pout
    d80_ms = time_ms(lambda: bk.bdpt_megakernel_pixels(*a, mis=True), reps=5)
    print(f"phase 2: bdpt_megakernel_pixels bdpt-mis mixed 64x64 x 4 spp, depth 80: "
          f"kernel {d80_ms:.3f} ms ({card})")
    lap("phase 2 (BDPT)")

    # ---- phase 3: the main path
    cfg = dataclasses.replace(cornell_box_camera(), image_width=512,
                              samples_per_pixel=16, max_depth=10,
                              integrator="pt")
    with capture(pk, "strata_sum") as sums3:  # warm-up; records the in-order sum's launch
        render(scene, cfg, seed=0)
    pk.pt_megakernel.launches = pk.pt_megakernel_pixels.launches = pk.strata_sum.launches = 0
    pk.pt_megakernel_plain.calls = pk.pt_megakernel_pixels_plain.calls = 0
    pk.strata_sum_plain.calls = 0
    results = [render(scene, cfg, seed=0) for _ in range(3)]
    launches = pk.pt_megakernel.launches + pk.pt_megakernel_pixels.launches
    sum_launches = pk.strata_sum.launches
    plain_calls = (pk.pt_megakernel_plain.calls + pk.pt_megakernel_pixels_plain.calls
                   + pk.strata_sum_plain.calls)
    check(pk.pt_megakernel_pixels.launches > 0, "main path launched no kernel")
    check(sum_launches == pk.pt_megakernel_pixels.launches,
          f"main path: {sum_launches} strata_sum launches, not one a megakernel launch")
    check(plain_calls == 0, f"main path called the plain version {plain_calls} times")
    walls = [r.stats.wall_seconds for r in results]
    wall = statistics.median(walls)
    res = refs[("cornell", "pt")] = results[0]  # phase 25's reference
    rays = res.stats.rays_traced
    fb = res.framebuffer_sum
    check(fb.shape == (512, 512, 3), f"framebuffer shape {fb.shape}")
    check(bool(np.isfinite(fb).all()), "non-finite framebuffer")
    check(float(fb.mean()) > 0.0, "black image")
    check(all(np.array_equal(r.framebuffer_sum, fb) for r in results[1:]),
          "renders with the same seed differ")
    check(abs(rays - EXPECTED_RAYS) <= 1e-4 * EXPECTED_RAYS,
          f"rays_traced {rays} is not within 0.01% of {EXPECTED_RAYS}")
    path = write_png("chip_smoke_cornell_pt.png", res.rgb8(), output_dir="output")
    print(f"phase 3: render 512x512 16 spp depth 10 seed 0: walls "
          f"{[round(w, 6) for w in walls]} s, median {wall:.6f} s, "
          f"{rays / wall / 1e6:.3f} Mrays/s; rays_traced {rays} "
          f"(expected {EXPECTED_RAYS}, "
          f"{(rays - EXPECTED_RAYS) / EXPECTED_RAYS * 100:+.4f}%; TPU bench "
          f"{TPU_BENCH_RAYS}, {(rays - TPU_BENCH_RAYS) / TPU_BENCH_RAYS * 100:+.4f}%)"
          f"; tri tests {res.stats.triangle_tests}, "
          f"tri hits {res.stats.triangle_hits}; kernel launches {launches}, strata_sum "
          f"launches {sum_launches}, plain calls {plain_calls}; wrote {path} ({card})")
    # strata_sum at the main path's shape: the rows of the warm-up's launch
    # (one stratum range, added from zeros), bitwise against its plain version
    check(len(sums3) == 1 and sums3[0][1]["first"], "main path: not one strata_sum from zeros")
    rows3 = sums3[0][0][0]
    tot3 = torch.empty((3, rows3.shape[2]), device=dev)
    sum_out = pk.strata_sum(rows3, tot3.clone(), first=True)
    sum_plain = pk.strata_sum_plain(rows3, tot3.clone(), first=True)
    check(torch.equal(sum_out, sum_plain), "strata_sum differs from its plain version")
    sum_err = float((sum_out - sum_plain).abs().max())
    sum_ms = time_ms(lambda: pk.strata_sum(rows3, tot3, first=True), reps=20)
    sum_plain_ms = time_ms(lambda: pk.strata_sum_plain(rows3, tot3, first=True), reps=20)
    sum_lib_ms = time_ms(lambda: torch.sum(rows3, dim=1), reps=20)
    # rows read once and the totals written once; an add a sample and channel
    sum_bound = bound((rows3.numel() + tot3.numel()) * 4, rows3.numel())
    print(f"phase 3: strata_sum on the main path's rows {list(rows3.shape)}: equal to its plain "
          f"version to the bit; kernel {sum_ms:.4f} ms, plain (one add a stratum) "
          f"{sum_plain_ms:.4f} ms, torch.sum {sum_lib_ms:.4f} ms, bound {sum_bound[0]:.4f} ms "
          f"({sum_bound[1]}) ({card})")
    del sums3, rows3, tot3, sum_out, sum_plain
    lap("phase 3 (PT)")

    # ---- phase 3, BDPT and BDPT-MIS main paths (the CLI's default)
    bdpt_launches = 0
    for name in ("bdpt", "bdpt-mis"):
        cfg = dataclasses.replace(cfg, integrator=name)
        render(scene, cfg, seed=0)  # warm-up
        bk.bdpt_megakernel.launches = bk.bdpt_megakernel_pixels.launches = 0
        bk.bdpt_megakernel_plain.calls = bk.bdpt_megakernel_pixels_plain.calls = 0
        results = [render(scene, cfg, seed=0) for _ in range(3)]
        n_launch = bk.bdpt_megakernel.launches + bk.bdpt_megakernel_pixels.launches
        n_plain = bk.bdpt_megakernel_plain.calls + bk.bdpt_megakernel_pixels_plain.calls
        check(bk.bdpt_megakernel_pixels.launches > 0, f"{name} main path launched no kernel")
        check(n_plain == 0, f"{name} main path called the plain version {n_plain} times")
        bdpt_launches += n_launch
        walls = [r.stats.wall_seconds for r in results]
        wall = statistics.median(walls)
        res = refs[("cornell", name)] = results[0]
        fb = res.framebuffer_sum
        check(fb.shape == (512, 512, 3), f"{name} framebuffer shape {fb.shape}")
        check(bool(np.isfinite(fb).all()), f"{name}: non-finite framebuffer")
        check(float(fb.mean()) > 0.0, f"{name}: black image")
        check(all(np.array_equal(r.framebuffer_sum, fb) for r in results[1:]),
              f"{name}: renders with the same seed differ")
        st = res.stats
        check(st.rays_traced > 0 and st.shadow_rays > 0, f"{name}: no rays counted")
        tpu_rays, tpu_shadow = TPU_BENCH_BDPT[name]
        cpu_rays, cpu_shadow = CPU_REF_BDPT[name]
        path = write_png(f"chip_smoke_cornell_{name}.png", res.rgb8(), output_dir="output")
        print(f"phase 3: render {name} 512x512 16 spp depth 10 seed 0: walls "
              f"{[round(w, 6) for w in walls]} s, median {wall:.6f} s, "
              f"{st.rays_traced / wall / 1e6:.3f} Mrays/s on rays_traced "
              f"({st.total_rays / wall / 1e6:.3f} with shadow rays); rays_traced "
              f"{st.rays_traced} ({_gap(st.rays_traced, tpu_rays, cpu_rays)}), "
              f"shadow_rays {st.shadow_rays} "
              f"({_gap(st.shadow_rays, tpu_shadow, cpu_shadow)}); tri tests "
              f"{st.triangle_tests}, tri hits {st.triangle_hits}; kernel launches "
              f"{n_launch}, plain calls {n_plain}; wrote {path} ({card})")
        lap(f"phase 3 ({name})")

    # ---- phase 4: the coffee stand-in, from its OBJ files
    from bpt_tpu_torch.ops.kernels import pt_wave as pw
    from bpt_tpu_torch.scene.types import scene_from_numpy, scene_to_numpy

    t0 = time.monotonic()
    cb = coffee_builder()
    t_parse = time.monotonic() - t0
    host = cb.build(device="cpu")
    t_bvh = time.monotonic() - t0 - t_parse
    coffee = scene_from_numpy(*scene_to_numpy(host), device=dev)
    torch.cuda.synchronize()
    t_up = time.monotonic() - t0 - t_parse - t_bvh
    arrays, meta = scene_to_numpy(coffee)
    try:
        import yaml  # noqa: F401
    except ImportError:
        how = "SceneBuilder calls only (PyYAML is not installed here)"
    else:
        from bpt_tpu_torch.scene.loader import load_scene_from_yaml

        loaded = load_scene_from_yaml(COFFEE_YAML, device=dev, verbose=False).scene
        la, lm = scene_to_numpy(loaded)
        check(lm == meta and all(np.array_equal(la[k], arrays[k]) for k in arrays),
              "the loader's coffee scene differs from the builder's")
        how = "SceneBuilder calls, and the YAML loader gives the same scene"
        del loaded
    check(coffee.num_tris == 91_540 and coffee.use_bvh, f"coffee: {coffee.num_tris} tris")
    print(f"phase 4: coffee stand-in, {coffee.num_tris} triangles, "
          f"{int(coffee.bvh_skip.shape[0])} BVH nodes, {coffee.num_lights} light "
          f"triangles via {how}; parse {t_parse:.3f} s, BVH and tables {t_bvh:.3f} s, "
          f"upload {t_up:.3f} s")
    lap("phase 4")

    # ---- phase 5: closest_bvh vs bvh_closest
    ccc = camera_constants(coffee_camera(), torch.float32, dev)
    B = 65536
    o_p, d_p, ids_p = wave_rays(ccc, torch.arange(B, device=dev) * 4, 1, key, dev)
    lo, hi = (x.cpu().numpy() for x in (coffee.bvh_min[0], coffee.bvh_max[0]))
    o_r = Vec3(*torch.from_numpy(g.uniform(lo, hi, (B, 3)).astype(np.float32)).to(dev).unbind(1))
    d_r = Vec3(*torch.from_numpy(g.normal(size=(B, 3)).astype(np.float32)).to(dev).unbind(1))
    act = torch.ones(B, dtype=torch.bool, device=dev)
    a_frac, a_err = 1.0, 0.0
    for name, o_, d_ in (("primary", o_p, d_p), ("random", o_r, d_r)):
        kout = pw.closest_bvh(coffee, o_, d_, act)
        pout, a_plain_ms = timed(lambda: pw.closest_bvh_plain(coffee, o_, d_, act))
        same = (kout[1] == pout[1]) & ((kout[0] == pout[0]) | (kout[0].isinf() & pout[0].isinf()))
        frac = float(same.double().mean())
        kc, pc = kout[4].tolist(), pout[4].tolist()
        print(f"phase 5: closest_bvh {name} rays B={B}: hit, tri and t equal on "
              f"{frac * 100:.4f}% of lanes ({int((kout[1] >= 0).sum())} hits); counters "
              f"(node visits, box hits, tri tests, tri hits) kernel {kc} plain {pc}; "
              f"plain {a_plain_ms:.3f} ms")
        check(frac >= MIN_FRAC, f"closest_bvh {name}: only {frac:.5f} of lanes agree")
        check(kc == pc, f"closest_bvh {name}: counters differ")
        both = kout[0].isfinite() & pout[0].isfinite()
        a_frac = min(a_frac, frac)
        a_err = max(a_err, float((kout[0] - pout[0])[both].abs().max()))
        if name == "primary":
            a_counts, a_plain_primary_ms = kc, a_plain_ms
    a_ms = time_ms(lambda: pw.closest_bvh(coffee, o_p, d_p, act), reps=10)
    tables = pw.pack_bvh(coffee)
    scene_bytes = sum(t.numel() * t.element_size() for t in tables)
    walk_bytes = sum(t.numel() * t.element_size() for t in pw.walk_tables(coffee))
    a_bound, a_by = bound(closest_bytes(act) + walk_bytes,
                          a_counts[0] * SLAB_OPS + a_counts[2] * MT_OPS)
    print(f"phase 5: closest_bvh primary rays B={B}: kernel {a_ms:.3f} ms, plain "
          f"{a_plain_primary_ms:.3f} ms, bound {a_bound:.4f} ms ({a_by}) ({card})")
    lap("phase 5")

    # ---- phase 6: any_bvh vs bvh_any on coffee shadow rays
    from bpt_tpu_torch.models.bdpt import bdpt_fast, bdpt_jnp
    from bpt_tpu_torch.models.render import jnp_raygen
    from bpt_tpu_torch.ops import soa

    ccb = camera_constants(coffee_camera(spp=4), torch.float32, dev)
    lane = torch.arange(4096, device=dev)
    o_c, d_c, ids_c = jnp_raygen(ccb, lane * 64, lane % 4, key, torch.float32)
    with capture(soa, "any_hit") as waves:
        bdpt_jnp(coffee, o_c, d_c, ids_c, key, depth, mis=True)
    check(len(waves) == depth, f"{len(waves)} shadow waves, not {depth}")
    real = [shadow_lanes(*w) for w in waves.values()]
    half = B // 2
    o_s, d_s = (Vec3(*(torch.cat([torch.cat([r[k][c] for r in real])[::12][:half],
                                  rnd[c][:half]]) for c in range(3)))
                for k, rnd in ((0, o_r), (1, d_r)))
    tmax_r = torch.from_numpy(g.uniform(0.0, float(np.linalg.norm(hi - lo)), half)
                              .astype(np.float32)).to(dev)
    tmax_r[::8] = 0.0
    tmax_s = torch.cat([torch.cat([r[2] for r in real])[::12][:half], tmax_r])
    del waves, real
    pw.any_bvh.launches = pw.any_bvh_plain.calls = 0
    hit_k, c_k = pw.any_bvh(coffee, o_s, d_s, tmax_s)
    (hit_p, c_p), s_plain_ms = timed(lambda: pw.any_bvh_plain(coffee, o_s, d_s, tmax_s))
    s_counts, dead = c_k.tolist(), float((tmax_s[:half] <= 0).double().mean())
    print(f"phase 6: any_bvh on {B} coffee shadow rays ({half} of a BDPT-MIS wave's "
          f"connections, {dead * 100:.2f}% of them dead; {half} random): answers equal on "
          f"{float((hit_k == hit_p).double().mean()) * 100:.4f}% of lanes ({int(hit_k.sum())} "
          f"hits); counters (node visits, box hits, tri tests, tri hits) kernel {s_counts} "
          f"plain {c_p.tolist()}; plain {s_plain_ms:.3f} ms")
    check(pw.any_bvh.launches == 1 and pw.any_bvh_plain.calls == 1, "any_bvh dispatch")
    check(torch.equal(hit_k, hit_p), "any_bvh: answers differ from bvh_any")
    check(s_counts == c_p.tolist(), "any_bvh: counters differ from bvh_any")
    any_err = float((hit_k != hit_p).float().max())
    s_ms = time_ms(lambda: pw.any_bvh(coffee, o_s, d_s, tmax_s), reps=10)
    s_bound, s_by = bound(any_bytes(tmax_s) + walk_bytes,
                          s_counts[0] * SLAB_OPS + s_counts[2] * MT_OPS)
    print(f"phase 6: any_bvh B={B}: kernel {s_ms:.3f} ms, plain {s_plain_ms:.3f} ms, bound "
          f"{s_bound:.4f} ms ({s_by}) ({card})")
    del o_s, d_s, tmax_s, hit_k, hit_p
    lap("phase 6")

    # ---- phase 7: pt_wave vs pt_wave_plain, both modes
    key_pt = rng.fold_in(key, 1)
    depth_w = 4
    wave_args = (coffee, o_p, d_p, ids_p, key_pt, depth_w)
    wplain, wave_plain_ms = timed(lambda: pw.pt_wave_plain(*wave_args))
    wave_err, wave_frac, wave_ms = 0.0, 1.0, {}
    for paged in (False, True):
        pw.closest_bvh.launches = pw.pt_wave_bounce.launches = 0
        pw.closest_bvh_plain.calls = pw.pt_wave_bounce_plain.calls = 0
        kout = pw.pt_wave(*wave_args, paged=paged)
        torch.cuda.synchronize()
        a_launches, b_launches = pw.closest_bvh.launches, pw.pt_wave_bounce.launches
        n_plain = pw.closest_bvh_plain.calls + pw.pt_wave_bounce_plain.calls
        mode = "paged (hits from pt_wave's closest_bvh call)" if paged else "walk"
        f, e = compare(f"phase 7: pt_wave {mode} B={B} depth={depth_w}", kout, wplain,
                       exact_counts=True)
        check(b_launches == a_launches == depth_w and not n_plain,
              f"pt_wave {mode}: launches {a_launches} / {b_launches}, plain calls {n_plain}")
        wave_err, wave_frac = max(wave_err, e), min(wave_frac, f)
        wave_ms[paged] = time_ms(lambda: pw.pt_wave(*wave_args, paged=paged), reps=5)
    print(f"phase 7: pt_wave B={B} depth={depth_w}: walk {wave_ms[False]:.3f} ms, paged "
          f"{wave_ms[True]:.3f} ms, plain {wave_plain_ms:.3f} ms (one call) ({card})")
    del wplain, kout
    lap("phase 7")

    # ---- phase 8: the coffee PT main path, through pt_wave
    cfg = coffee_camera()
    with capture(pw, "pt_wave_bounce") as bounces:  # the warm-up records its launches
        render(coffee, cfg, seed=0)
    check(len(bounces) == depth, f"coffee PT: {len(bounces)} wave-kernel launches, not {depth}")
    plains = (pk.pt_megakernel_plain, pk.pt_megakernel_pixels_plain, pk.strata_sum_plain,
              bk.bdpt_megakernel_plain, bk.bdpt_megakernel_pixels_plain,
              pw.closest_bvh_plain, pw.any_bvh_plain, pw.pt_wave_bounce_plain,
              pw.pt_wave_plain, soa.bvh_closest, soa.bvh_any)
    for fn in plains:
        fn.calls = 0
    pw.closest_bvh.launches = pw.any_bvh.launches = pw.pt_wave_bounce.launches = 0
    results = [render(coffee, cfg, seed=0) for _ in range(3)]
    wave_launches = pw.pt_wave_bounce.launches
    n_plain = sum(fn.calls for fn in plains)
    check(wave_launches > 0, "coffee main path launched no wave kernel")
    check(n_plain == 0, f"coffee main path called a plain version {n_plain} times")
    pt_walk_launches = pw.closest_bvh.launches
    check(pt_walk_launches == wave_launches and pw.any_bvh.launches == 0,
          f"coffee PT launched closest_bvh {pt_walk_launches} times, the wave kernel "
          f"{wave_launches}, any_bvh {pw.any_bvh.launches}")
    walls = [r.stats.wall_seconds for r in results]
    wall = statistics.median(walls)
    res = refs[("coffee", "pt")] = results[0]
    st = res.stats
    fb = res.framebuffer_sum
    check(fb.shape == (512, 512, 3), f"coffee framebuffer shape {fb.shape}")
    check(bool(np.isfinite(fb).all()), "coffee: non-finite framebuffer")
    check(float(fb.mean()) > 0.0, "coffee: black image")
    check(all(np.array_equal(r.framebuffer_sum, fb) for r in results[1:]),
          "coffee: renders with the same seed differ")
    # the subset of tools/coffee_reference_rays.py, through the kernels
    sub = wave_rays(ccc, torch.arange(0, 512 * 512, 257, device=dev), 16, key, dev)
    sub_rays = int(pw.pt_wave(coffee, *sub, key_pt, depth)[3])
    check(abs(sub_rays - CPU_BVH_COFFEE_SUBSET) <= 1e-3 * CPU_BVH_COFFEE_SUBSET,
          f"coffee subset rays {sub_rays} not within 0.1% of {CPU_BVH_COFFEE_SUBSET}")
    scaled = TPU_BENCH_COFFEE_RAYS * CPU_BVH_COFFEE_SUBSET / CPU_PALLAS_COFFEE_SUBSET
    check(abs(st.rays_traced - scaled) <= 1e-2 * scaled,
          f"coffee rays_traced {st.rays_traced} not within 1% of {scaled:.0f}")
    path = write_png("chip_smoke_coffee_pt.png", res.rgb8(), output_dir="output")
    tpu_gap = (st.rays_traced - TPU_BENCH_COFFEE_RAYS) / TPU_BENCH_COFFEE_RAYS * 100
    print(f"phase 8: render coffee 512x512 16 spp depth 10 seed 0: walls "
          f"{[round(w, 6) for w in walls]} s, median {wall:.6f} s, "
          f"{st.rays_traced / wall / 1e6:.3f} Mrays/s; rays_traced {st.rays_traced} "
          f"(TPU bench {TPU_BENCH_COFFEE_RAYS}, {tpu_gap:+.4f}%; that count scaled by "
          f"bpt_tpu's BVH / Pallas ratio {scaled:.0f}, "
          f"{(st.rays_traced - scaled) / scaled * 100:+.4f}%); every 257th pixel: "
          f"{sub_rays} rays (bpt_tpu's BVH path on a CPU {CPU_BVH_COFFEE_SUBSET}, "
          f"{(sub_rays - CPU_BVH_COFFEE_SUBSET) / CPU_BVH_COFFEE_SUBSET * 100:+.4f}%; "
          f"its Pallas pt_wave {CPU_PALLAS_COFFEE_SUBSET}); node visits "
          f"{st.bvh_node_visits}, box hits {st.aabb_hits}, tri tests {st.triangle_tests}, "
          f"tri hits {st.triangle_hits}; wave kernel launches {wave_launches}, closest_bvh "
          f"launches {pt_walk_launches}, plain calls {n_plain}; wrote {path} ({card})")

    del results, res, fb

    # the wave kernel at the main path's first bounce: 16 strata of 512^2
    o_m, d_m, ids_m = wave_rays(ccc, torch.arange(512 * 512, device=dev), 16, key, dev)
    Bm = int(ids_m.shape[0])
    state = torch.empty((pw.STATE_ROWS, Bm), device=dev)
    state[pw.OX:pw.DX + 3] = torch.stack([*o_m, *d_m])
    state[pw.THR:pw.THR + 3] = 1.0
    state[pw.RAD:pw.RAD + 3] = 0.0
    state[pw.ALIVE] = 1.0
    del o_m, d_m
    b_out, b_counts = pw.pt_wave_bounce(coffee, state, ids_m, key_pt, 0, tables=tables)
    b_ms = time_ms(lambda: pw.pt_wave_bounce(coffee, state, ids_m, key_pt, 0,
                                             tables=tables), reps=5)
    # the shade alone, on closest_bvh's hits of these rays
    hits_m = pw.closest_bvh(coffee, Vec3(*state[pw.OX:pw.OX + 3]),
                            Vec3(*state[pw.DX:pw.DX + 3]), state[pw.ALIVE] > 0.5)[:2]
    b_shade_ms = time_ms(lambda: pw.pt_wave_bounce(coffee, state, ids_m, key_pt, 0, hits_m,
                                                   tables=tables), reps=5)
    (p_out, p_counts), b_plain_ms = timed(
        lambda: pw.pt_wave_bounce_plain(coffee, state, ids_m, key_pt, 0))
    # every state row; a dead lane's origin, direction and throughput are
    # never read again, so those rows count on the lanes the plain version
    # keeps alive (a lane alive on one side only fails on the alive row)
    live = p_out[pw.ALIVE] > 0.5
    rows, prows = (torch.cat([torch.where(live, x[:pw.RAD], 0.0), x[pw.RAD:]]).T
                   for x in (b_out, p_out))
    f, e, worst = agreement(rows, prows)
    b_counts, p_counts = b_counts.tolist(), p_counts.tolist()
    check(bool(live.any()), "wave kernel at bounce 0: no lane stays alive")
    check(f >= MIN_FRAC, f"wave kernel at bounce 0: only {f:.5f} of lanes agree; worst "
          f"lane {worst}: kernel {rows[worst].tolist()} plain {prows[worst].tolist()}")
    check(b_counts == p_counts, f"wave kernel at bounce 0: counters {b_counts} vs {p_counts}")
    wave_err, wave_frac = max(wave_err, e), min(wave_frac, f)
    b_lanes = Bm
    b_bound, b_by = bound(Bm * (2 * pw.STATE_ROWS * 4 + 4) + scene_bytes,
                          b_counts[1] * SLAB_OPS + b_counts[3] * MT_OPS)
    # every launch of one render, each on its own inputs, and their bound
    b_render = [(int((a[1][pw.ALIVE] > 0.5).sum()),
                 time_ms(lambda: pw.pt_wave_bounce(*a, **kw), reps=3),
                 pw.pt_wave_bounce(*a, **kw)[1].tolist()) for a, kw in bounces.values()]
    b_render_bound = sum(bound(Bm * (2 * pw.STATE_ROWS * 4 + 4) + scene_bytes,
                               c[1] * SLAB_OPS + c[3] * MT_OPS)[0] for _, _, c in b_render)
    b_render_ms = sum(ms for _, ms, _ in b_render)
    del bounces
    print(f"phase 8: wave kernel, first bounce of the main path (B={Bm}): kernels "
          f"(closest_bvh's walk + the shade) {b_ms:.3f} ms, the shade alone {b_shade_ms:.3f} "
          f"ms, plain {b_plain_ms:.3f} ms (one call), bound {b_bound:.4f} ms "
          f"({b_by}); all {pw.STATE_ROWS} state rows within rtol {RTOL} / atol {ATOL} "
          f"on {f * 100:.4f}% of lanes ({int(live.sum())} alive), max abs err {e:.3e}; counters "
          f"(rays, node visits, box hits, tri tests, tri hits) kernel {b_counts} plain "
          f"{p_counts} ({card})")
    print(f"phase 8: walk + shade, the {len(b_render)} bounces of one render (live lanes: "
          f"ms): {', '.join(f'{n}: {ms:.3f}' for n, ms, _ in b_render)}; sum {b_render_ms:.3f} "
          f"ms, bound {b_render_bound:.4f} ms ({card})")
    del state, b_out, p_out, rows, prows, hits_m
    lap("phase 8")

    # ---- phase 9: the large-scene BDPT route against its plain traversals
    from bpt_tpu_torch.models.render import _bdpt_wave_shape, _render_strata

    # 16x16, depth 2: the torch walks' time goes with the longest walk of a
    # traversal more than with its lanes, and a deeper route walks more
    W9, D9 = 16, 2
    cfg9 = coffee_camera(width=W9, spp=4, depth=D9, integrator="bdpt-mis")
    cc9 = camera_constants(cfg9, torch.float32, dev)
    runs = {}
    for plain in (False, True):
        for fn in plains:
            fn.calls = 0
        pw.closest_bvh.launches = pw.any_bvh.launches = 0
        fb9 = torch.zeros((W9 * W9, 3), device=dev)
        (r9, sh9, ex9), ms9 = timed(lambda: _render_strata(
            coffee, cfg9, cc9, "bdpt-mis", 0, fb9, None, None, None, plain=plain,
            bdpt_wave=True))
        launched = pw.closest_bvh.launches + pw.any_bvh.launches
        walks = soa.bvh_closest.calls + soa.bvh_any.calls
        n_plain = sum(fn.calls for fn in plains)
        if plain:
            check(launched == 0 and walks > 0 and walks == n_plain,
                  f"plain route: {launched} kernel launches, {walks} walks")
        else:
            check(launched > 0 and n_plain == 0,
                  f"kernel route: {launched} launches, {n_plain} plain calls")
        runs[plain] = (fb9, [int(r9), int(sh9), *ex9.tolist()], ms9, launched or walks)
    f9, e9, w9 = agreement(runs[False][0], runs[True][0], BDPT_ATOL)
    bitwise = torch.equal(runs[False][0], runs[True][0])
    print(f"phase 9: coffee bdpt-mis {W9}x{W9} 4 spp depth {D9}, kernels vs plain traversals: "
          f"{f9 * 100:.4f}% of pixels within rtol {RTOL} / atol {BDPT_ATOL} (bitwise "
          f"{'equal' if bitwise else 'different'}), max abs err {e9:.3e}; worst pixel {w9}: "
          f"kernels {runs[False][0][w9].tolist()} plain {runs[True][0][w9].tolist()}; counters "
          f"(rays, shadow, nodes, aabb, tri tests, tri hits) kernels {runs[False][1]} plain "
          f"{runs[True][1]}; {runs[False][3]} launches in {runs[False][2]:.1f} ms, "
          f"{runs[True][3]} plain walks in {runs[True][2]:.1f} ms ({card})")
    check(f9 >= MIN_FRAC, f"BDPT route: only {f9:.5f} of pixels agree with the plain walks")
    check(runs[False][1] == runs[True][1], "BDPT route: counters differ from the plain walks")
    del runs
    lap("phase 9")

    # ---- phase 10: the BDPT main paths, coffee bdpt-mis and bdpt
    launchers = (pk.pt_megakernel, pk.pt_megakernel_pixels, bk.bdpt_megakernel,
                 bk.bdpt_megakernel_pixels, pw.pt_wave_bounce)
    closest_main = any_main = 0
    sub_pix = torch.arange(0, 512 * 512, 257, device=dev).repeat(4)
    sub_s = torch.arange(4, device=dev).repeat_interleave(sub_pix.numel() // 4)
    for name in ("bdpt-mis", "bdpt"):
        mis = name == "bdpt-mis"
        cfg = coffee_camera(spp=4, integrator=name)
        if mis:  # the warm-up records its closest-hit launches and one shadow wave
            with capture(pw, "closest_bvh") as cl, capture(soa, "any_hit") as an:
                render(coffee, cfg, seed=0)
            main_closest, main_shadows = cl, an
        else:
            render(coffee, cfg, seed=0)  # warm-up
        strata, span = _bdpt_wave_shape(512 * 512, 4, depth, mis)
        waves = math.ceil(4 / strata) * math.ceil(512 * 512 / span)
        for fn in plains:
            fn.calls = 0
        for fn in (*launchers, pw.closest_bvh, pw.any_bvh):
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        results = [render(coffee, cfg, seed=0) for _ in range(3)]
        peak = torch.cuda.max_memory_allocated(dev)
        n_closest, n_any = pw.closest_bvh.launches, pw.any_bvh.launches
        n_plain = sum(fn.calls for fn in plains)
        n_other = sum(fn.launches for fn in launchers)
        check(n_closest == 3 * waves * (2 * depth - 1) and n_any == 3 * waves * depth,
              f"coffee {name}: {n_closest} closest_bvh and {n_any} any_bvh launches in 3 "
              f"renders of {waves} waves")
        check(n_plain == 0 and n_other == 0,
              f"coffee {name}: {n_plain} plain calls, {n_other} other kernel launches")
        closest_main += n_closest
        any_main += n_any
        walls = [r.stats.wall_seconds for r in results]
        wall = statistics.median(walls)
        res = results[0]
        st = res.stats
        fb = res.framebuffer_sum
        check(fb.shape == (512, 512, 3), f"coffee {name} framebuffer shape {fb.shape}")
        check(bool(np.isfinite(fb).all()), f"coffee {name}: non-finite framebuffer")
        check(float(fb.mean()) > 0.0, f"coffee {name}: black image")
        check(all(np.array_equal(r.framebuffer_sum, fb) for r in results[1:]),
              f"coffee {name}: renders with the same seed differ")
        o_u, d_u, ids_u = jnp_raygen(ccb, sub_pix, sub_s, key, torch.float32)
        sub = [int(x) for x in bdpt_jnp(coffee, o_u, d_u, ids_u, key, depth, mis=mis)[1][:2]]
        ref = CPU_COFFEE_BDPT_SUBSET[name]
        gaps = [(a - b) / b * 100 for a, b in zip(sub, ref)]
        plain_sh = CPU_PLAIN_COFFEE_BDPT_SHADOW[name]
        sh_ref = ref[1] if mis else plain_sh
        sh_gap = (sub[1] - sh_ref) / sh_ref * 100
        path = write_png(f"chip_smoke_coffee_{name}.png", res.rgb8(), output_dir="output")
        tpu = (f"TPU bench {TPU_BENCH_COFFEE_BDPT_MIS[0]}, "
               f"{(st.rays_traced / TPU_BENCH_COFFEE_BDPT_MIS[0] - 1) * 100:+.4f}%; "
               if mis else "")
        tpu_sh = (f"TPU bench {TPU_BENCH_COFFEE_BDPT_MIS[1]}, "
                  f"{(st.shadow_rays / TPU_BENCH_COFFEE_BDPT_MIS[1] - 1) * 100:+.4f}%; "
                  if mis else "")
        print(f"phase 10: render coffee {name} 512x512 4 spp depth {depth} seed 0: walls "
              f"{[round(w, 6) for w in walls]} s, median {wall:.6f} s, "
              f"{st.rays_traced / wall / 1e6:.3f} Mrays/s on rays_traced "
              f"({st.total_rays / wall / 1e6:.3f} with shadow rays); rays_traced "
              f"{st.rays_traced} ({tpu}not a target: ROADMAP §3), shadow_rays "
              f"{st.shadow_rays} ({tpu_sh}not a target); every 257th pixel: rays {sub[0]}, "
              f"shadow {sub[1]} (bpt_tpu's CPU route {ref[0]}, {ref[1]}: {gaps[0]:+.4f}%, "
              f"{gaps[1]:+.4f}%; the port's plain route on a CPU: shadow {plain_sh}); node "
              f"visits {st.bvh_node_visits}, box hits {st.aabb_hits}, "
              f"tri tests {st.triangle_tests}, tri hits {st.triangle_hits}; {waves} wave(s) "
              f"of {strata} strata x {span} pixels a render; peak device memory "
              f"{peak / 2**30:.2f} GiB; closest_bvh {n_closest} and any_bvh {n_any} "
              f"launches, plain calls {n_plain}; wrote {path} ({card})")
        if mis:  # the default route's render, for phases 18, 21 and 25
            default_mis = (st.rays_traced, st.shadow_rays, fb.copy())
            refs[("coffee", name)] = res
            wave_mis_wall = wall
        check(abs(gaps[0]) <= 0.1, f"coffee {name}: subset rays {sub[0]} not within 0.1% "
              f"of {ref[0]}")
        check(abs(sh_gap) <= 1.0, f"coffee {name}: subset shadow rays {sub[1]} not within "
              f"1% of {sh_ref}")
        del results, res, fb
        lap(f"phase 10 ({name})")

    # closest_bvh and any_bvh at the main path's own shapes: the warm-up
    # render's camera bounce 1 and its shadow wave of camera vertex 1
    check(len(main_closest) == 2 * depth - 1,
          f"coffee bdpt-mis: {len(main_closest)} closest_bvh launches a wave")
    o_m, d_m, act_m = main_closest[1][0][1:4]
    Bc = int(act_m.shape[0])
    kout = pw.closest_bvh(coffee, o_m, d_m, act_m)
    pout, cm_plain_ms = timed(lambda: pw.closest_bvh_plain(coffee, o_m, d_m, act_m))
    same = (kout[1] == pout[1]) & ((kout[0] == pout[0]) | (kout[0].isinf() & pout[0].isinf()))
    cm_frac, cm_counts = float(same.double().mean()), kout[4].tolist()
    both = kout[0].isfinite() & pout[0].isfinite()
    a_err = max(a_err, float((kout[0] - pout[0])[both].abs().max()))
    a_frac = min(a_frac, cm_frac)
    check(cm_frac >= MIN_FRAC, f"closest_bvh at the main path's shape: {cm_frac:.5f} agree")
    check(cm_counts == pout[4].tolist(), "closest_bvh at the main path's shape: counters")
    cm_ms = time_ms(lambda: pw.closest_bvh(coffee, o_m, d_m, act_m), reps=5)
    cm_bound, cm_by = bound(closest_bytes(act_m) + walk_bytes,
                            cm_counts[0] * SLAB_OPS + cm_counts[2] * MT_OPS)
    print(f"phase 10: closest_bvh, camera bounce 1 of the bdpt-mis wave (B={Bc}, "
          f"{int(act_m.sum())} live): kernel {cm_ms:.3f} ms, plain {cm_plain_ms:.3f} ms (one "
          f"call), bound {cm_bound:.4f} ms ({cm_by}); hit, tri and t equal on "
          f"{cm_frac * 100:.4f}% of lanes; counters kernel {cm_counts} plain "
          f"{pout[4].tolist()} ({card})")
    # every launch of one render, each on its own inputs, and their bound
    cm_render = [(int(a[3].sum()), time_ms(lambda: pw.closest_bvh(*a), reps=3),
                  pw.closest_bvh(*a)[4].tolist()) for a, _ in main_closest.values()]
    cm_render_bound = sum(bound(closest_bytes(a[3]) + walk_bytes,
                                c[0] * SLAB_OPS + c[2] * MT_OPS)[0]
                          for (a, _), (_, _, c) in zip(main_closest.values(), cm_render))
    cm_render_ms = sum(ms for _, ms, _ in cm_render)
    print(f"phase 10: closest_bvh, the {len(cm_render)} launches of one bdpt-mis render (live "
          f"lanes: ms): {', '.join(f'{n}: {ms:.3f}' for n, ms, _ in cm_render)}; sum "
          f"{cm_render_ms:.3f} ms, bound {cm_render_bound:.4f} ms ({card})")
    del kout, pout, same, both, main_closest, o_m, d_m, act_m
    check(len(main_shadows) == depth, f"coffee bdpt-mis: {len(main_shadows)} shadow waves")
    o_w, d_w, t_w = shadow_lanes(*main_shadows[1])
    Bs = int(t_w.shape[0])
    hit_k, c_k = pw.any_bvh(coffee, o_w, d_w, t_w)
    (hit_p, c_p), am_plain_ms = timed(lambda: pw.any_bvh_plain(coffee, o_w, d_w, t_w))
    am_frac, am_counts = float((hit_k == hit_p).double().mean()), c_k.tolist()
    any_err = max(any_err, float((hit_k != hit_p).float().max()))
    check(torch.equal(hit_k, hit_p) and am_counts == c_p.tolist(),
          f"any_bvh at the main path's shape: {am_frac:.6f} agree, counters {am_counts} "
          f"vs {c_p.tolist()}")
    am_ms = time_ms(lambda: pw.any_bvh(coffee, o_w, d_w, t_w), reps=5)
    am_bound, am_by = bound(any_bytes(t_w) + walk_bytes,
                            am_counts[0] * SLAB_OPS + am_counts[2] * MT_OPS)
    print(f"phase 10: any_bvh, the shadow wave of camera vertex 1 (B={Bs}, "
          f"{int((t_w > 0).sum())} live): kernel {am_ms:.3f} ms, plain {am_plain_ms:.3f} ms "
          f"(one call), bound {am_bound:.4f} ms ({am_by}); answers and counters {am_counts} "
          f"equal ({card})")
    del o_w, d_w, t_w, hit_k, hit_p
    # every shadow wave of one render, each on its own inputs, and their bound
    am_render, am_render_bound = [], 0.0
    for args, kw in main_shadows.values():
        lanes_w = shadow_lanes(args, kw)
        c_w = pw.any_bvh(coffee, *lanes_w)[1].tolist()
        am_render.append((int((lanes_w[2] > 0).sum()),
                          time_ms(lambda: pw.any_bvh(coffee, *lanes_w), reps=3)))
        am_render_bound += bound(any_bytes(lanes_w[2]) + walk_bytes,
                                 c_w[0] * SLAB_OPS + c_w[2] * MT_OPS)[0]
    am_render_ms = sum(ms for _, ms in am_render)
    print(f"phase 10: any_bvh, the {len(am_render)} shadow waves of one bdpt-mis render (live "
          f"lanes: ms): {', '.join(f'{n}: {ms:.3f}' for n, ms in am_render)}; sum "
          f"{am_render_ms:.3f} ms, bound {am_render_bound:.4f} ms ({card})")
    del main_shadows, lanes_w
    lap("phase 10")

    # ---- phase 11: closest_tri / any_tri vs brute_closest / brute_any
    from bpt_tpu_torch.ops.kernels import intersect as ki

    tri_err, tri_frac = 0.0, 1.0
    for dtype in (torch.float32, torch.float64):
        for sc_name, sc in (("cornell", cornell_box(device=dev, dtype=dtype)),
                            ("256-triangle soup", tri_soup(254, 3, dev, dtype))):
            check(not sc.use_bvh and sc.dtype == dtype, f"{sc_name}: {sc.num_tris} tris")
            e, f = compare_tri(f"phase 11: closest_tri / any_tri {sc_name} {dtype}", sc,
                               *tri_lanes(65_536 + 77, 5, dev, dtype), card)
            tri_err, tri_frac = max(tri_err, e), min(tri_frac, f)
    lap("phase 11")

    # ---- phase 12: the ref_vis BDPT main path, 256x256 / 64 spp / depth 10
    from bpt_tpu_torch.models.render import _wave_spp_batch
    from bpt_tpu_torch.ops.intersect import T_MIN
    from bpt_tpu_torch.utils.png import read_png

    tri_kernels = (ki.closest_tri, ki.any_tri)
    tri_plains = (ki.closest_tri_plain, ki.any_tri_plain)
    everything = (*launchers, pw.closest_bvh, pw.any_bvh)
    all_plains = (*plains, *tri_plains)
    cfg12 = dataclasses.replace(cornell_box_camera(), image_width=256, samples_per_pixel=64,
                                max_depth=depth, integrator="bdpt", ref_vis=True)
    t0 = time.monotonic()
    # the warm-up times each hit launch on its own inputs and keeps camera
    # bounce 1's and the shadow wave of camera vertex 1's
    with (tri_launch_times(ki, "closest_tri", keep={1}) as cl,
          tri_launch_times(ki, "any_tri", keep={1}) as an):
        render(scene, cfg12, seed=0)
    warm = time.monotonic() - t0
    strata, span = _bdpt_wave_shape(256 * 256, 64, depth, False)
    waves = math.ceil(64 / strata) * math.ceil(256 * 256 / span)
    check([len(cl["launches"]), len(an["launches"])] == [waves * (2 * depth - 1), waves * depth],
          f"ref_vis warm-up: {len(cl['launches'])} closest_tri, {len(an['launches'])} any_tri "
          f"launches in {waves} waves")
    for fn in all_plains:
        fn.calls = 0
    for fn in (*everything, *tri_kernels):
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    results = [render(scene, cfg12, seed=0) for _ in range(3)]
    peak = torch.cuda.max_memory_allocated(dev)
    tri_launches = [fn.launches for fn in tri_kernels]
    n_plain = sum(fn.calls for fn in all_plains)
    n_other = sum(fn.launches for fn in everything)
    check(tri_launches == [3 * waves * (2 * depth - 1), 3 * waves * depth],
          f"ref_vis main path: {tri_launches} closest_tri / any_tri launches in 3 renders of "
          f"{waves} waves")
    check(n_plain == 0 and n_other == 0,
          f"ref_vis main path: {n_plain} plain calls, {n_other} other kernel launches")
    walls = [r.stats.wall_seconds for r in results]
    wall = statistics.median(walls)
    res = results[0]
    st, fb = res.stats, res.framebuffer_sum
    check(fb.shape == (256, 256, 3) and bool(np.isfinite(fb).all()) and float(fb.mean()) > 0,
          "ref_vis main path: framebuffer not finite, black or misshapen")
    check(all(np.array_equal(r.framebuffer_sum, fb) for r in results[1:]),
          "ref_vis main path: renders with the same seed differ")

    def down(img, f=8):
        h, w, c = img.shape
        return img.reshape(h // f, f, w // f, f, c).mean((1, 3))

    gold = read_png(REF_BDPT_PNG).astype(np.float64) / 255.0
    ours = res.rgb8().astype(np.float64) / 255.0
    rmse = float(np.sqrt(np.mean((down(ours) - down(gold)) ** 2)))
    check(rmse < REF_RMSE_BOUND, f"ref_vis main path: downsampled RMSE {rmse:.4f} against the "
          f"reference binary's image, bound {REF_RMSE_BOUND}")
    path = write_png("chip_smoke_cornell_ref_vis.png", res.rgb8(), output_dir="output")
    # every 257th pixel x 64 strata, on the card and by the port's plain route on a CPU
    cc12 = camera_constants(cfg12, torch.float32, dev)
    sub_pix = torch.arange(0, 256 * 256, 257).repeat(64)
    sub_s = torch.arange(64).repeat_interleave(sub_pix.numel() // 64)
    sub = {}
    for where, sc in (("card", scene), ("cpu", cornell_box(device="cpu"))):
        cc_w = cc12 if where == "card" else camera_constants(cfg12, torch.float32, "cpu")
        o_u, d_u, ids_u = jnp_raygen(cc_w, sub_pix.to(sc.device), sub_s.to(sc.device), key,
                                     torch.float32)
        rad_u, st_u = bdpt_fast(sc, o_u, d_u, ids_u, key, depth, ref_vis=True)
        sub[where] = (int(st_u.rays_traced), int(st_u.shadow_rays), float(rad_u.mean()))
    ray_gap = (sub["card"][0] - CPU_REFVIS_SUBSET[0]) / CPU_REFVIS_SUBSET[0] * 100
    sh_gap = (sub["card"][1] - sub["cpu"][1]) / sub["cpu"][1] * 100
    print(f"phase 12: render cornell bdpt ref_vis 256x256 64 spp depth {depth} seed 0: warm-up "
          f"{warm:.3f} s, walls {[round(w, 6) for w in walls]} s, median {wall:.6f} s, "
          f"{st.rays_traced / wall / 1e6:.3f} Mrays/s on rays_traced "
          f"({st.total_rays / wall / 1e6:.3f} with shadow rays); rays_traced {st.rays_traced}, "
          f"shadow_rays {st.shadow_rays}, tri tests {st.triangle_tests}, tri hits "
          f"{st.triangle_hits}; {waves} wave(s) of {strata} strata x {span} pixels; peak device "
          f"memory {peak / 2**30:.2f} GiB; closest_tri / any_tri launches {tri_launches}, plain "
          f"calls {n_plain}; downsampled RMSE against {REF_BDPT_PNG} {rmse:.4f} (bound "
          f"{REF_RMSE_BOUND}); wrote {path} ({card})")
    print(f"phase 12: every 257th pixel x 64 strata: card rays {sub['card'][0]}, shadow "
          f"{sub['card'][1]}, mean radiance {sub['card'][2]:.6f}; bpt_tpu's CPU route rays "
          f"{CPU_REFVIS_SUBSET[0]} ({ray_gap:+.4f}%), shadow {CPU_REFVIS_SUBSET[1]} "
          f"({(sub['card'][1] / CPU_REFVIS_SUBSET[1] - 1) * 100:+.4f}%: ties at the endpoint), "
          f"mean radiance {CPU_REFVIS_SUBSET[2]:.6f} "
          f"({(sub['card'][2] / CPU_REFVIS_SUBSET[2] - 1) * 100:+.4f}%); the port's plain route "
          f"on this CPU: rays {sub['cpu'][0]}, shadow {sub['cpu'][1]} ({sh_gap:+.4f}%), mean "
          f"radiance {sub['cpu'][2]:.6f} (recorded here: shadow {CPU_PLAIN_REFVIS_SHADOW}) ({card})")
    check(abs(ray_gap) <= 0.1, f"ref_vis subset rays {sub['card'][0]} not within 0.1% of "
          f"{CPU_REFVIS_SUBSET[0]}")
    check(abs(sh_gap) <= 1.0, f"ref_vis subset shadow rays {sub['card'][1]} not within 1% of "
          f"the plain route's {sub['cpu'][1]}")
    del results, res, fb

    # the kernels at the main path's own shapes (camera bounce 1 of the
    # wave; the shadow wave of camera vertex 1, its ten light rows), timed,
    # and against their plain versions on a strided slice of each
    ct_args, at_args = cl["kept"][1], an["kept"][1]
    Bt_c, Bt_s = int(ct_args[3].shape[0]), int(at_args[3].shape[0])
    live_c = int((ct_args[3] <= ct_args[4]).sum())
    live_s = int((at_args[3] <= at_args[4]).sum())
    live_rows = (at_args[3] <= at_args[4]).view(-1, Bt_c).sum(dim=1).tolist()
    e, f, ct_sl_ms, ct_plain_ms, ct_n = tri_slice_vs_plain("closest_tri", "camera bounce 1",
                                                           ct_args, 4, card)
    e2, f2, at_sl_ms, at_plain_ms, at_n = tri_slice_vs_plain(
        "any_tri", "the shadow wave of camera vertex 1", at_args, 40, card)
    tri_err, tri_frac = max(tri_err, e, e2), min(tri_frac, f, f2)
    ct_ms = time_ms(lambda: ki.closest_tri(*ct_args), reps=10)
    at_ms = time_ms(lambda: ki.any_tri(*at_args), reps=10)
    (ct_bound, ct_by), (at_bound, at_by) = (tri_bound("closest_tri", *ct_args),
                                            tri_bound("any_tri", *at_args))
    with torch.cuda.device(dev):
        tri_grids = [build.load_library().bpt_tri_blocks(0, a) for a in (0, 1)]
    print(f"phase 12: closest_tri, camera bounce 1 (B={Bt_c}, {live_c} live): kernel "
          f"{ct_ms:.3f} ms, bound {ct_bound:.4f} ms ({ct_by}); on every 4th lane ({ct_n}): "
          f"kernel {ct_sl_ms:.3f} ms, plain {ct_plain_ms:.3f} ms (one call); persistent grid "
          f"{tri_grids[0]} blocks ({card})")
    print(f"phase 12: any_tri, the shadow wave of camera vertex 1 (B={Bt_s}, {live_s} live; "
          f"live lanes a light row {live_rows}): kernel {at_ms:.3f} ms, bound {at_bound:.4f} "
          f"ms ({at_by}); on every 40th lane ({at_n}): kernel {at_sl_ms:.3f} ms, plain "
          f"{at_plain_ms:.3f} ms (one call); persistent grid {tri_grids[1]} blocks ({card})")
    ct_render, at_render = cl["launches"], an["launches"]
    ct_render_ms, at_render_ms = (sum(x[2] for x in r) for r in (ct_render, at_render))
    for name, rows, tot in (("closest_tri", ct_render, ct_render_ms),
                            ("any_tri", at_render, at_render_ms)):
        print(f"phase 12: {name}, the {len(rows)} launches of the warm-up render, each on its "
              f"own inputs (live lanes of B: ms): "
              f"{', '.join(f'{n} of {b}: {ms:.3f}' for b, n, ms, _ in rows)}; sum {tot:.3f} "
              f"ms, bound {sum(x[3] for x in rows):.4f} ms ({card})")
    del ct_args, at_args, cl, an

    # the route against its plain twin on the card at 64x64, 16 spp
    cfg64 = dataclasses.replace(cfg12, image_width=64, samples_per_pixel=16)
    cc64 = camera_constants(cfg64, torch.float32, dev)
    twin = {}
    for plain in (False, True):
        for fn in all_plains:
            fn.calls = 0
        for fn in (*everything, *tri_kernels):
            fn.launches = 0
        fb64 = torch.zeros((64 * 64, 3), device=dev)
        out = _render_strata(scene, cfg64, cc64, "bdpt", 0, fb64, None, None, None, plain=plain)
        torch.cuda.synchronize()
        counts = [int(out[0]), int(out[1]), *out[2].tolist()]
        launched = sum(fn.launches for fn in (*everything, *tri_kernels))
        n_plain = sum(fn.calls for fn in all_plains)
        check(launched == (0 if plain else 29) and n_plain == (29 if plain else 0),
              f"64x64 route plain={plain}: {launched} launches, {n_plain} plain calls")
        twin[plain] = (fb64, counts)
    check(torch.equal(twin[False][0], twin[True][0]) and twin[False][1] == twin[True][1],
          f"the 64x64 ref_vis route differs from its plain twin: counters {twin[False][1]} vs "
          f"{twin[True][1]}, max abs err {float((twin[False][0] - twin[True][0]).abs().max()):.3e}")
    print(f"phase 12: the ref_vis route at 64x64, 16 spp equals its plain=True twin bitwise, "
          f"counters (rays, shadow, nodes, aabb, tri tests, tri hits) {twin[False][1]} ({card})")
    del twin
    lap("phase 12")

    # ---- phase 13: defocus on the card, through the rays-mode megakernels
    centre = (277.5, 277.5, 277.5)
    rays_mode_launches, waves13 = {}, {}
    for name in ("pt", "bdpt"):
        cam = cornell_box_camera()
        cfg13 = dataclasses.replace(cam, image_width=512, samples_per_pixel=16, max_depth=depth,
                                    integrator=name, defocus_angle=1.0,
                                    focus_dist=math.dist(cam.lookfrom, centre))
        with capture(pk, "pt_megakernel") as pt13, capture(bk, "bdpt_megakernel") as bdpt13:
            render(scene, cfg13, seed=0)  # warm-up; records the wave's launch
        waves13[name] = pt13 if name == "pt" else bdpt13
        mk = pk.pt_megakernel if name == "pt" else bk.bdpt_megakernel
        waves = (math.ceil(16 / _wave_spp_batch(512 * 512, 16)) if name == "pt"
                 else math.ceil(16 / _bdpt_wave_shape(512 * 512, 16, depth, False)[0]))
        for fn in all_plains:
            fn.calls = 0
        for fn in (*everything, *tri_kernels):
            fn.launches = 0
        results = [render(scene, cfg13, seed=0) for _ in range(3)]
        n_mk = mk.launches
        n_other = sum(fn.launches for fn in (*everything, *tri_kernels)) - n_mk
        n_plain = sum(fn.calls for fn in all_plains)
        check(n_mk == 3 * waves and n_other == 0 and n_plain == 0,
              f"defocus {name}: {n_mk} rays-mode launches, {n_other} other launches, {n_plain} "
              "plain calls")
        rays_mode_launches[name] = n_mk
        walls = [r.stats.wall_seconds for r in results]
        wall = statistics.median(walls)
        st, fb = results[0].stats, results[0].framebuffer_sum
        check(bool(np.isfinite(fb).all()) and float(fb.mean()) > 0,
              f"defocus {name}: non-finite or black image")
        check(all(np.array_equal(r.framebuffer_sum, fb) for r in results[1:]),
              f"defocus {name}: renders with the same seed differ")
        path = write_png(f"chip_smoke_cornell_defocus_{name}.png", results[0].rgb8(),
                         output_dir="output")
        print(f"phase 13: render cornell {name} defocus_angle 1.0 focus_dist "
              f"{cfg13.focus_dist:.1f} 512x512 16 spp depth {depth}: walls "
              f"{[round(w, 6) for w in walls]} s, median {wall:.6f} s, "
              f"{st.rays_traced / wall / 1e6:.3f} Mrays/s; rays_traced {st.rays_traced}, "
              f"shadow_rays {st.shadow_rays}; {mk.__name__} rays-mode launches {n_mk}, other "
              f"launches {n_other}, plain calls {n_plain}; wrote {path} ({card})")
        del results, fb
    # each wave's launch (B = 4,194,304) timed on its own inputs, bounded and
    # held against its plain version on every 16th lane
    res13 = {}
    for name, tab13 in (("pt", pk._pack_tables(scene)), ("bdpt", bk._pack_tables_bdpt(scene))):
        check(len(waves13[name]) == 1,
              f"defocus {name}: {len(waves13[name])} rays-mode launches a render")
        args13, kw13 = waves13[name][0]
        B13 = int(args13[3].shape[0])
        out13, frac13, err13, plain13_ms, n13 = defocus_wave_vs_plain(name, args13, kw13)
        c13 = counters(out13)
        mk = pk.pt_megakernel if name == "pt" else bk.bdpt_megakernel
        ms13 = time_ms(lambda: mk(*args13, **kw13), reps=3)
        # lanes in: o, d, id; radiance out; the tables once; the sweeps'
        # triangle tests (the tri-tests counter) at MT_OPS each
        bound13 = bound(B13 * 40 + sum(t.numel() * t.element_size() for t in tab13),
                        c13[3 if name == "pt" else 4] * MT_OPS)
        res13[name] = dict(ms=ms13, bound=bound13, frac=frac13, err=err13, plain_ms=plain13_ms,
                           lanes=n13, B=B13)
        print(f"phase 13: {mk.__name__} rays mode on the defocus {name} wave (B={B13}): kernel "
              f"{ms13:.3f} ms, bound {bound13[0]:.4f} ms ({bound13[1]}); counters {c13}; plain "
              f"version on every 16th lane ({n13}) {plain13_ms:.3f} ms ({card})")
        del args13, kw13, out13
    bdpt_err = max(bdpt_err, res13["bdpt"]["err"])
    bdpt_frac = min(bdpt_frac, res13["bdpt"]["frac"])
    max_err, frac = max(max_err, res13["pt"]["err"]), min(frac, res13["pt"]["frac"])
    del waves13
    lap("phase 13")

    # ---- phase 14: the CLI's --f64 through the float64 instantiation
    from bpt_tpu_torch import render as cli

    for fn in all_plains:
        fn.calls = 0
    for fn in (*everything, *tri_kernels):
        fn.launches = 0
    argv = ["--f64", "--size", "64x64", "--spp", "4", "--output", "chip_smoke_f64.png",
            "--no-progress"]
    rc = cli.main(argv)
    f64_launches = [fn.launches for fn in tri_kernels]
    n_plain = sum(fn.calls for fn in all_plains)
    print(f"phase 14: python -m bpt_tpu_torch.render {' '.join(argv)}: exit {rc}; "
          f"closest_tri / any_tri float64 launches {f64_launches}, plain calls {n_plain} ({card})")
    check(rc == 0 and min(f64_launches) > 0 and n_plain == 0, "--f64 did not render on the card")
    lap("phase 14")

    # ---- phase 15: the megakernels' walk mode against their plain versions
    from bpt_tpu_torch.models.camera import generate_rays
    from bpt_tpu_torch.models.render import (
        _render_chunks,
        _render_wave,
        _route,
        default_chunk_size,
    )

    big = big_scene(dev)
    check(big.num_tris == 964 and pk.use_walk(big) and big.use_bvh, "big scene")
    walk_err = dict.fromkeys(WALK_KERNELS, 0.0)
    walk_frac = dict.fromkeys(WALK_KERNELS, 1.0)

    def walk_check(kname, name, kout, pout, atol):
        f, e = compare(f"phase 15: {name}", kout, pout, exact_counts=True, atol=atol)
        walk_err[kname] = max(walk_err[kname], e)
        walk_frac[kname] = min(walk_frac[kname], f)

    def walk_rays(kname, sc, o_, d_, ids_, k_, dep, u=None, mis=False):
        """(kernel, plain, plain ms) of one rays-mode walk launch."""
        if kname == "pt_megakernel_walk":
            a = (sc, o_, d_, ids_, k_, dep)
            kout = pk.pt_megakernel(*a, uniforms=u)
            pout, p_ms = timed(lambda: pk.pt_megakernel_plain(*a, uniforms=u))
        else:
            a = (sc, o_, d_, ids_, k_, dep)
            kout = bk.bdpt_megakernel(*a, uniforms=u, mis=mis)
            pout, p_ms = timed(lambda: bk.bdpt_megakernel_plain(*a, uniforms=u, mis=mis))
        return kout, pout, p_ms

    def walk_pixels(kname, sc, cfg_, k_, mis=False):
        """(kernel, plain, plain ms, args) of one pixels-mode walk launch of
        a whole image, every stratum in the kernel."""
        cc_ = camera_constants(cfg_, torch.float32, dev)
        n = cc_.width * cc_.height
        pix_ = torch.arange(n, dtype=torch.int64, device=dev)
        i_, j_ = (pix_ % cc_.width).float(), (pix_ // cc_.width).float()
        S_ = cfg_.sqrt_spp
        if kname == "pt_megakernel_pixels_walk":
            a = (sc, i_, j_, i_ * 0, j_ * 0, pix_, pk.camera_table(cc_), k_, cfg_.max_depth)
            kw = dict(spp_loop=S_ * S_, sqrt_spp=S_)
            kout = pk.pt_megakernel_pixels(*a, **kw)
            pout, p_ms = timed(lambda: pk.pt_megakernel_pixels_plain(*a, **kw))
            return kout, pout, p_ms, (a, kw)
        a = (sc, i_, j_, pix_, pk.camera_table(cc_), k_, cfg_.max_depth, S_)
        kw = dict(mis=mis)
        kout = bk.bdpt_megakernel_pixels(*a, **kw)
        pout, p_ms = timed(lambda: bk.bdpt_megakernel_pixels_plain(*a, **kw))
        return kout, pout, p_ms, (a, kw)

    # the 964-triangle scene at B = 65,536, depth 10: rays mode with injected
    # uniforms and on the kernel's stream, pixels mode at 256x256, 1 spp; the
    # kernels timed at these shapes beside their plain versions
    B15 = 65536
    g15 = np.random.default_rng(15)
    o15 = torch.from_numpy((g15.uniform(-3, 3, (B15, 3)) * [1, 0.5, 1] + [0, 2.5, 0])
                           .astype(np.float32)).to(dev)
    d15 = torch.from_numpy(g15.normal(size=(B15, 3)).astype(np.float32)).to(dev)
    ov15, dv15 = Vec3(*o15.unbind(1)), Vec3(*d15.unbind(1))
    ids15 = torch.arange(B15, dtype=torch.int32, device=dev)
    ids15[::13] = -1
    walk_plain, walk_slice_ms = {}, {}
    for kname, mis, slots, atol in (("pt_megakernel_walk", False, depth * NU, ATOL),
                                    ("bdpt_megakernel_walk", False, n_slots, BDPT_ATOL),
                                    ("bdpt_megakernel_walk", True, n_slots, BDPT_ATOL)):
        u15 = torch.from_numpy(g15.uniform(size=(slots, B15)).astype(np.float32)).to(dev)
        for mode, u in (("buffer", u15), ("rng", None)):
            kout, pout, p_ms = walk_rays(kname, big, ov15, dv15, ids15, key, depth, u, mis)
            torch.cuda.synchronize()
            name = "pt" if kname.startswith("pt") else ("bdpt-mis" if mis else "bdpt")
            walk_check(kname, f"{kname} {name} {mode} mode big scene B={B15} depth={depth} "
                       f"(plain {p_ms:.1f} ms)", kout, pout, atol)
            walk_plain.setdefault(kname, p_ms)
        if kname not in walk_slice_ms:
            fn = pk.pt_megakernel if kname.startswith("pt") else bk.bdpt_megakernel
            walk_slice_ms[kname] = time_ms(lambda: fn(big, ov15, dv15, ids15, key, depth,
                                                      uniforms=u15), reps=5)
    cfg_big = dataclasses.replace(coffee_camera(width=256, spp=1, depth=depth), vfov=40.0,
                                  lookfrom=(0.0, 2.0, 6.0), lookat=(0.0, 1.0, 0.0))
    for kname, mis, atol in (("pt_megakernel_pixels_walk", False, ATOL),
                             ("bdpt_megakernel_pixels_walk", False, BDPT_ATOL),
                             ("bdpt_megakernel_pixels_walk", True, BDPT_ATOL)):
        kout, pout, p_ms, (a, kw) = walk_pixels(kname, big, cfg_big, key, mis)
        torch.cuda.synchronize()
        walk_check(kname, f"{kname}{' bdpt-mis' if mis else ''} big scene 256x256 1 spp "
                   f"depth={depth} (plain {p_ms:.1f} ms)", kout, pout, atol)
        if kname not in walk_slice_ms:
            fn = pk.pt_megakernel_pixels if kname.startswith("pt") else bk.bdpt_megakernel_pixels
            walk_slice_ms[kname] = time_ms(lambda: fn(*a, **kw), reps=5)
            walk_plain[kname] = p_ms
    walk_plain_shape = {k: (f"the 964-triangle scene, {B15} lanes, depth {depth}"
                            + (", bdpt" if k.startswith("bdpt") else ""))
                        for k in WALK_KERNELS}
    del o15, d15, ov15, dv15, kout, pout
    lap("phase 15 (big scene)")

    # the coffee stand-in: its torch walks take 10-15 s a bounce whatever
    # the lane count (the longest walk's steps), so the plain PT version
    # runs at 8x8 pixels and depth 2 (bdpt-mis: a pixel of the main path,
    # phase 16); at the real shapes, and at depth 80, the plain estimator
    # runs over closest_bvh / any_bvh (walks_on_kernels)
    kout, pout, p_ms, _ = walk_pixels("pt_megakernel_pixels_walk", coffee,
                                      coffee_camera(width=8, spp=1, depth=2), key)
    walk_check("pt_megakernel_pixels_walk", f"pt_megakernel_pixels_walk coffee 8x8 1 spp "
               f"depth=2 (plain {p_ms:.1f} ms)", kout, pout, ATOL)
    key_pt = rng.fold_in(key, 1)
    o_q, d_q, ids_q = wave_rays(ccc, torch.arange(B15, device=dev) * 4, 1, key, dev)
    lane_q = torch.arange(B15 // 4, device=dev)
    o_b, d_b, ids_b = jnp_raygen(ccb, lane_q * 16, lane_q % 4, key, torch.float32)
    with walks_on_kernels():
        kout, pout, r_ms = walk_rays("pt_megakernel_walk", coffee, o_q, d_q, ids_q, key_pt, depth)
        walk_check("pt_megakernel_walk", f"pt_megakernel_walk pt rng mode coffee B={B15} "
                   f"depth={depth} (plain estimator over the BVH kernels {r_ms:.1f} ms)",
                   kout, pout, ATOL)
        kout, pout, r_ms = walk_rays("bdpt_megakernel_walk", coffee, Vec3(*o_b.unbind(1)),
                                     Vec3(*d_b.unbind(1)), ids_b.to(torch.int32), key, depth,
                                     None, True)
        walk_check("bdpt_megakernel_walk", f"bdpt_megakernel_walk bdpt-mis rng mode coffee "
                   f"B={B15 // 4} depth={depth} (plain estimator over the BVH kernels "
                   f"{r_ms:.1f} ms)", kout, pout, BDPT_ATOL)
        for kname, mis, width, dep, atol in (
                ("pt_megakernel_pixels_walk", False, 128, depth, ATOL),
                ("bdpt_megakernel_pixels_walk", False, 128, depth, BDPT_ATOL),
                ("bdpt_megakernel_pixels_walk", True, 64, 80, BDPT_ATOL)):
            cfg_q = coffee_camera(width=width, spp=1, depth=dep)
            kout, pout, r_ms, (a, kw) = walk_pixels(kname, coffee, cfg_q, key, mis)
            walk_check(kname, f"{kname}{' bdpt-mis' if mis else ''} coffee {width}x{width} 1 "
                       f"spp depth={dep} (plain estimator over the BVH kernels {r_ms:.1f} ms)",
                       kout, pout, atol)
    walk_d80_ms = time_ms(lambda: bk.bdpt_megakernel_pixels(*a, **kw), reps=5)
    del kout, pout, o_q, d_q, o_b, d_b
    lap("phase 15 (coffee)")

    # the coffee subsets against bpt_tpu's counts for the fused kernels'
    # stream on a CPU: PT, every 257th pixel x 16 strata of 512x512 / d10
    # (pt_wave draws the same stream: tools/coffee_reference_rays.py); BDPT
    # and BDPT-MIS, every 257th pixel x 4 strata of 512x512 / d10
    # (tools/coffee_reference_rays_fused.py)
    sub_pix = torch.arange(0, 512 * 512, 257, device=dev)
    si, sj = (sub_pix % 512).float(), (sub_pix // 512).float()
    cam16 = pk.camera_table(ccc)
    sub_pt = int(pk.pt_megakernel_pixels(coffee, si, sj, si * 0, sj * 0, sub_pix, cam16, key,
                                         depth, spp_loop=16, sqrt_spp=4)[3])
    pt_gap = (sub_pt - CPU_BVH_COFFEE_SUBSET) / CPU_BVH_COFFEE_SUBSET * 100
    print(f"phase 15: fused PT on every 257th pixel x 16 strata of coffee 512x512 depth "
          f"{depth}: rays {sub_pt} (bpt_tpu's BVH path on this stream on a CPU "
          f"{CPU_BVH_COFFEE_SUBSET}, {pt_gap:+.4f}%) ({card})")
    check(abs(pt_gap) <= 0.1, f"fused PT subset rays {sub_pt} not within 0.1%")
    cam4 = pk.camera_table(ccb)
    for name in ("bdpt-mis", "bdpt"):
        out = bk.bdpt_megakernel_pixels(coffee, si, sj, sub_pix, cam4, key, depth, 2,
                                        mis=name == "bdpt-mis")
        got = (int(out[3]), int(out[4]))
        ref, plain_sh = CPU_FUSED_COFFEE_SUBSET[name], CPU_PLAIN_FUSED_COFFEE_SHADOW[name]
        sh_ref = ref[1] if name == "bdpt-mis" else plain_sh
        gaps = [(got[0] - ref[0]) / ref[0] * 100, (got[1] - sh_ref) / sh_ref * 100]
        print(f"phase 15: fused {name} on every 257th pixel x 4 strata of coffee 512x512 depth "
              f"{depth}: rays {got[0]}, shadow {got[1]} (bpt_tpu's jnp estimator on this stream "
              f"on a CPU {ref[0]}, {ref[1]}: {gaps[0]:+.4f}%, "
              f"{(got[1] - ref[1]) / ref[1] * 100:+.4f}%; the port's plain kernel on a CPU: "
              f"shadow {plain_sh}, {(got[1] - plain_sh) / plain_sh * 100:+.4f}%) ({card})")
        check(abs(gaps[0]) <= 0.1 and abs(gaps[1]) <= 1.0,
              f"fused {name} subset counts {got} not within 0.1% / 1% of {ref[0]}, {sh_ref}")
    lap("phase 15")

    # ---- phase 16: the slice's main path, coffee bdpt-mis 512x512 / 4 spp / depth 80
    cfg16 = coffee_camera(spp=4, depth=80, integrator="bdpt-mis")
    check(_route(coffee, cfg16, "bdpt-mis", None) == "fused", "coffee d80: not the fused route")
    render(coffee, cfg16, seed=0)  # warm-up
    for fn in all_plains:
        fn.calls = 0
    for fn in (*everything, *tri_kernels):
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    results = [render(coffee, cfg16, seed=0) for _ in range(3)]
    peak16 = torch.cuda.max_memory_allocated(dev)
    main_launches = bk.bdpt_megakernel_pixels.launches
    n_other = sum(fn.launches for fn in (*everything, *tri_kernels)) - main_launches
    n_plain = sum(fn.calls for fn in all_plains)
    check(main_launches == 3 and n_other == 0 and n_plain == 0,
          f"coffee bdpt-mis d80: {main_launches} pixels-mode launches in 3 renders, {n_other} "
          f"other launches, {n_plain} plain calls")
    walls = [r.stats.wall_seconds for r in results]
    wall = statistics.median(walls)
    st, fb = results[0].stats, results[0].framebuffer_sum
    check(fb.shape == (512, 512, 3) and bool(np.isfinite(fb).all()) and float(fb.mean()) > 0,
          "coffee bdpt-mis d80: framebuffer not finite, black or misshapen")
    check(all(np.array_equal(r.framebuffer_sum, fb) for r in results[1:]),
          "coffee bdpt-mis d80: renders with the same seed differ")
    path = write_png("chip_smoke_coffee_bdpt-mis_d80.png", results[0].rgb8(), output_dir="output")
    print(f"phase 16: render coffee bdpt-mis 512x512 4 spp depth 80 seed 0 (fused, walk mode): "
          f"walls {[round(w, 6) for w in walls]} s, median {wall:.6f} s (the BDPT wave loop "
          f"took {WAVE_D80_WALL} s here), {st.rays_traced / wall / 1e6:.3f} Mrays/s on "
          f"rays_traced ({st.total_rays / wall / 1e6:.3f} with shadow rays); rays_traced "
          f"{st.rays_traced}, shadow_rays {st.shadow_rays}; node visits {st.bvh_node_visits}, "
          f"box hits {st.aabb_hits}, tri tests {st.triangle_tests}, tri hits "
          f"{st.triangle_hits}; peak device memory {peak16 / 2**30:.2f} GiB (the wave loop: "
          f"{WAVE_D80_PEAK_GIB} GiB); bdpt_megakernel_pixels launches {main_launches}, other "
          f"launches {n_other}, plain calls {n_plain}; wrote {path} ({card})")
    # the kernel at the main path's own shape: one 2^18-pixel chunk
    npx = 512 * 512
    pix16 = torch.arange(npx, dtype=torch.int64, device=dev)
    args16 = (coffee, (pix16 % 512).float(), (pix16 // 512).float(), pix16,
              pk.camera_table(camera_constants(cfg16, torch.float32, dev)), key, 80, 2)
    torch.cuda.reset_peak_memory_stats(dev)
    out16, main_ms = timed(lambda: bk.bdpt_megakernel_pixels(*args16, mis=True))
    kernel_peak16 = torch.cuda.max_memory_allocated(dev)
    c16 = counters(out16)
    with torch.cuda.device(dev):
        grid16 = build.load_library().bpt_bdpt_blocks(1, 0)
    fb_sha = hashlib.sha256(np.ascontiguousarray(fb).tobytes()).hexdigest()
    print(f"phase 16: bdpt_megakernel_pixels walk mode at the main path's chunk (512x512 "
          f"pixels x 4 spp, depth 80): kernel {main_ms:.3f} ms, peak device memory "
          f"{kernel_peak16 / 2**30:.3f} GiB; persistent grid {grid16} blocks x "
          f"{pk.WALK_BLOCK} threads; vertex scratch "
          f"{bk.walk_scratch_bytes(grid16 * pk.WALK_BLOCK, 80, True)} B; the render's "
          f"framebuffer sha256 {fb_sha} ({card})")
    # the kernel against its plain version on the main path's own inputs:
    # every 16th pixel of the chunk with the plain estimator's walks over
    # closest_bvh / any_bvh (walks_on_kernels; the torch walks would take
    # hours at depth 80), and 4 of its pixels walking in torch.  Each slice
    # is also launched alone, which must give the chunk's radiance on its
    # lanes bitwise, for the slice's counters
    kname16 = "bdpt_megakernel_pixels_walk"
    walk_err[kname16], walk_frac[kname16] = 0.0, 1.0
    slices16 = {"over the BVH kernels": (torch.arange(0, npx, 16, device=dev), True),
                "walking in torch": (torch.arange(4, device=dev) * 65536 + 32768 + 256, False)}
    plain16_ms = {}
    for how, (sl, on_kernels) in slices16.items():
        a_sl = (coffee, args16[1][sl], args16[2][sl], args16[3][sl], *args16[4:])
        k_sl = bk.bdpt_megakernel_pixels(*a_sl, mis=True)
        check(all(torch.equal(k_sl[c], out16[c][sl]) for c in range(3)),
              f"phase 16: the slice's own launch differs from the chunk's on its lanes")
        with walks_on_kernels() if on_kernels else contextlib.nullcontext():
            p_sl, plain16_ms[how] = timed(
                lambda: bk.bdpt_megakernel_pixels_plain(*a_sl, mis=True))
        f, e = compare(f"phase 16: {kname16} bdpt-mis on {sl.numel()} pixels of the main "
                       f"path's chunk (4 spp, depth 80), plain walks {how} "
                       f"({plain16_ms[how]:.1f} ms)", k_sl, p_sl, exact_counts=True,
                       atol=BDPT_ATOL)
        walk_err[kname16] = max(walk_err[kname16], e)
        walk_frac[kname16] = min(walk_frac[kname16], f)
    del k_sl, p_sl
    walk_ms = {"bdpt_megakernel_pixels_walk": main_ms}
    walk_bound = {"bdpt_megakernel_pixels_walk": bound(
        npx * (3 * 4 + 3 * 4) + walk_table_bytes(coffee, bdpt=True),
        c16[2] * SLAB_OPS + c16[4] * MT_OPS)}
    walk_launches = {"bdpt_megakernel_pixels_walk": main_launches}
    walk_plain[kname16] = plain16_ms["over the BVH kernels"]
    walk_plain_shape[kname16] = (
        f"every 16th pixel of the main path's chunk ({npx // 16} pixels x 4 spp, depth 80), "
        f"the plain estimator's walks over closest_bvh / any_bvh; 4 of its pixels walking "
        f"in torch in {plain16_ms['walking in torch']:.1f} ms")
    del results, fb, out16
    lap("phase 16")

    # ---- phase 17: coffee bdpt under 2^18 samples: fused against the stratum loop
    cfg17 = coffee_camera(width=256, spp=1, depth=depth, integrator="bdpt")
    cc17 = camera_constants(cfg17, torch.float32, dev)
    check(_route(coffee, cfg17, "bdpt", None) == "fused", "coffee bdpt 256x256: not fused")
    r17 = [render(coffee, cfg17, seed=0) for _ in range(2)]
    fused17 = r17[1]
    fb17 = torch.zeros((256 * 256, 3), device=dev)
    _render_strata(coffee, cfg17, cc17, "bdpt", 0, fb17, None, None, None, bdpt_wave=True)
    torch.cuda.synchronize()
    (s17, _, _), loop_ms = timed(lambda: _render_strata(
        coffee, cfg17, cc17, "bdpt", 0, fb17.zero_(), None, None, None, bdpt_wave=True))
    a17 = fused17.framebuffer_sum.reshape(-1, 3).mean(1).astype(np.float64)
    b17 = fb17.mean(1).double().cpu().numpy()
    noise = 5.0 * math.sqrt(a17.var() / a17.size + b17.var() / b17.size)
    print(f"phase 17: coffee bdpt 256x256 1 spp depth {depth}: fused {fused17.stats.wall_seconds:.6f} "
          f"s ({fused17.stats.rays_traced} rays, {fused17.stats.shadow_rays} shadow), the stratum "
          f"loop (forced, the jnp stream over closest_bvh / any_bvh) {loop_ms / 1e3:.6f} s "
          f"({int(s17)} rays); mean radiance {a17.mean():.6f} vs {b17.mean():.6f}, difference "
          f"{a17.mean() - b17.mean():+.6f} within 5 sigma {noise:.6f} ({card})")
    check(fused17.stats.wall_seconds > 0 and abs(a17.mean() - b17.mean()) <= noise,
          "coffee bdpt 256x256: the fused and stratum-loop means differ beyond their noise")
    del r17, fused17, fb17
    lap("phase 17")

    # ---- phase 18: coffee PT under 2^18 pixels: pt_wave (render()'s route)
    # against the fused loop's walk mode (bpt_tpu's route there), forced
    def fused_pt(cfg_, fb_):
        """The fused chunk loop on the coffee stand-in: (rays, ms)."""
        cc_ = camera_constants(cfg_, torch.float32, dev)
        n_ = cc_.width * cc_.height
        (r_, _, _), ms_ = timed(lambda: _render_chunks(
            coffee, cfg_, cc_, "pt", 0, fb_.zero_(), default_chunk_size(n_), 0, None, None))
        return int(r_), ms_

    cfg18 = coffee_camera(width=256, spp=16, depth=depth)
    check(_route(coffee, cfg18, "pt", None) == "wave", "coffee PT 256x256: not pt_wave")
    render(coffee, cfg18, seed=0)  # warm-up
    fb18 = torch.zeros((256 * 256, 3), device=dev)
    fused_pt(cfg18, fb18)  # warm-up
    for fn in all_plains:
        fn.calls = 0
    for fn in (*everything, *tri_kernels):
        fn.launches = 0
    r18 = [render(coffee, cfg18, seed=0) for _ in range(3)]
    n_wave, n_walk = pw.pt_wave_bounce.launches, pw.closest_bvh.launches
    n_other = sum(fn.launches for fn in (*everything, *tri_kernels)) - n_wave - n_walk
    n_plain = sum(fn.calls for fn in all_plains)
    check(n_wave == n_walk == 3 * depth and n_other == 0 and n_plain == 0,
          f"coffee PT 256x256: {n_wave} wave-kernel and {n_walk} closest_bvh launches, "
          f"{n_other} other, {n_plain} plain")
    fused18 = [fused_pt(cfg18, fb18) for _ in range(3)]
    pt_main = pk.pt_megakernel_pixels.launches
    n_other = sum(fn.launches for fn in (*everything, *tri_kernels)) - pt_main - n_wave - n_walk
    n_plain = sum(fn.calls for fn in all_plains)
    check(pt_main == 3 and n_other == 0 and n_plain == 0,
          f"coffee PT 256x256 fused: {pt_main} pixels-mode launches, {n_other} other, "
          f"{n_plain} plain")
    wave18 = r18[0]
    got18 = torch.from_numpy(wave18.framebuffer_sum.reshape(-1, 3)).to(dev)
    f18, e18, w18 = agreement(fb18, got18)
    wall18 = statistics.median(r.stats.wall_seconds for r in r18)
    fwall18 = statistics.median(ms for _, ms in fused18) / 1e3
    print(f"phase 18: coffee PT 256x256 16 spp depth {depth}: pt_wave (render()) walls "
          f"{[round(r.stats.wall_seconds, 6) for r in r18]} s, median {wall18:.6f} s "
          f"({wave18.stats.rays_traced / wall18 / 1e6:.3f} Mrays/s); the fused loop (forced) "
          f"walls {[round(ms / 1e3, 6) for _, ms in fused18]} s, median {fwall18:.6f} s; "
          f"rays_traced pt_wave {wave18.stats.rays_traced}, fused {fused18[0][0]}; "
          f"{f18 * 100:.4f}% of pixels within rtol {RTOL} / atol {ATOL} (bitwise "
          f"{'equal' if torch.equal(got18, fb18) else 'different'}), max abs diff {e18:.3e} "
          f"({card})")
    check(fused18[0][0] == wave18.stats.rays_traced,
          "coffee PT 256x256: fused and pt_wave rays differ")
    check(f18 >= MIN_FRAC, f"coffee PT 256x256: only {f18:.5f} of pixels agree with pt_wave")
    check(all(np.array_equal(r.framebuffer_sum, wave18.framebuffer_sum) for r in r18[1:]),
          "coffee PT 256x256: renders with the same seed differ")
    # the two routes on smaller images: where would the fused loop win?
    sweep = []
    for W_, spp_ in ((32, 1), (64, 4), (128, 16)):
        cfg_ = coffee_camera(width=W_, spp=spp_, depth=depth)
        check(_route(coffee, cfg_, "pt", None) == "wave", f"coffee PT {W_}x{W_}: not pt_wave")
        fb_ = torch.zeros((W_ * W_, 3), device=dev)
        render(coffee, cfg_, seed=0)
        fused_pt(cfg_, fb_)
        w_ = statistics.median(render(coffee, cfg_, seed=0).stats.wall_seconds
                               for _ in range(3))
        f_ = statistics.median(fused_pt(cfg_, fb_)[1] for _ in range(3)) / 1e3
        sweep.append(f"{W_}x{W_} {spp_} spp: pt_wave {w_:.6f} s, fused {f_:.6f} s "
                     f"({f_ / w_:.2f}x)")
    sweep.append(f"256x256 16 spp: pt_wave {wall18:.6f} s, fused {fwall18:.6f} s "
                 f"({fwall18 / wall18:.2f}x)")
    print(f"phase 18: coffee PT depth {depth}, medians of 3: {'; '.join(sweep)} ({card})")
    # coffee bdpt-mis at 512x512 / 4 spp / depth 10 (2^20 samples, the BDPT
    # wave's side of bpt_tpu's 2^18 constant): the fused loop forced, beside
    # the wave route's median of phase 10
    cfg_m = coffee_camera(spp=4, integrator="bdpt-mis")
    cc_m = camera_constants(cfg_m, torch.float32, dev)
    fb_m = torch.zeros((512 * 512, 3), device=dev)

    def fused_mis():
        (r_, _, _), ms_ = timed(lambda: _render_chunks(
            coffee, cfg_m, cc_m, "bdpt-mis", 0, fb_m.zero_(), default_chunk_size(512 * 512),
            0, None, None))
        return int(r_), ms_

    fused_mis()  # warm-up
    fm = [fused_mis() for _ in range(3)]
    fm_wall = statistics.median(ms for _, ms in fm) / 1e3
    print(f"phase 18: coffee bdpt-mis 512x512 4 spp depth {depth}: the fused loop (forced) "
          f"walls {[round(ms / 1e3, 6) for _, ms in fm]} s, median {fm_wall:.6f} s, rays "
          f"{fm[0][0]}; the BDPT wave route (render(), phase 10) median {wave_mis_wall:.6f} s "
          f"(fused / wave {fm_wall / wave_mis_wall:.2f}x) ({card})")
    del fb_m
    pix18 =torch.arange(256 * 256, dtype=torch.int64, device=dev)
    args18 = (coffee, (pix18 % 256).float(), (pix18 // 256).float(), pix18 * 0.0, pix18 * 0.0,
              pix18, pk.camera_table(camera_constants(cfg18, torch.float32, dev)), key, depth)
    walk_ms["pt_megakernel_pixels_walk"] = time_ms(lambda: pk.pt_megakernel_pixels(
        *args18, spp_loop=16, sqrt_spp=4), reps=3)
    c18 = counters(pk.pt_megakernel_pixels(*args18, spp_loop=16, sqrt_spp=4))
    walk_bound["pt_megakernel_pixels_walk"] = bound(
        256 * 256 * (5 * 4 + 3 * 4) + walk_table_bytes(coffee), c18[1] * SLAB_OPS
        + c18[3] * MT_OPS)
    walk_launches["pt_megakernel_pixels_walk"] = pt_main
    del r18, wave18, fb18, got18
    lap("phase 18")

    # ---- phase 19: defocus on the coffee stand-in, rays mode in the stratum loop
    for name in ("bdpt", "pt"):
        cam19 = coffee_camera(width=128, spp=4, depth=depth, integrator=name)
        cfg19 = dataclasses.replace(cam19, defocus_angle=1.0,
                                    focus_dist=math.dist(cam19.lookfrom, cam19.lookat))
        check(_route(coffee, cfg19, name, None) == "strata", f"coffee defocus {name} route")
        render(coffee, cfg19, seed=0)  # warm-up
        mk = pk.pt_megakernel if name == "pt" else bk.bdpt_megakernel
        for fn in all_plains:
            fn.calls = 0
        for fn in (*everything, *tri_kernels):
            fn.launches = 0
        r19 = [render(coffee, cfg19, seed=0) for _ in range(3)]
        n_mk = mk.launches
        n_other = sum(fn.launches for fn in (*everything, *tri_kernels)) - n_mk
        n_plain = sum(fn.calls for fn in all_plains)
        check(n_mk == 3 and n_other == 0 and n_plain == 0,
              f"coffee defocus {name}: {n_mk} rays-mode launches, {n_other} other, {n_plain} plain")
        fb = r19[0].framebuffer_sum
        check(bool(np.isfinite(fb).all()) and float(fb.mean()) > 0
              and all(np.array_equal(r.framebuffer_sum, fb) for r in r19[1:]),
              f"coffee defocus {name}: image non-finite, black or not deterministic")
        wall = statistics.median(r.stats.wall_seconds for r in r19)
        print(f"phase 19: render coffee {name} defocus_angle 1.0 128x128 4 spp depth {depth}: "
              f"walls {[round(r.stats.wall_seconds, 6) for r in r19]} s, median {wall:.6f} s, "
              f"rays_traced {r19[0].stats.rays_traced}, shadow_rays {r19[0].stats.shadow_rays}; "
              f"{mk.__name__} launches {n_mk} (one a wave), other launches {n_other}, plain calls "
              f"{n_plain} ({card})")
        # the wave's own launch: the stratum loop's jnp raygen for all 4 strata
        cc19 = camera_constants(cfg19, torch.float32, dev)
        pix19 = torch.arange(128 * 128, dtype=torch.int64, device=dev).repeat(4)
        s19 = torch.arange(4, device=dev).repeat_interleave(128 * 128)
        if name == "pt":
            ids19 = pix19 * 4 + s19
            u_gen = rng.wave_uniforms(rng.fold_in(key, 0), ids19, 0, 4, torch.float32)
            o19, d19 = generate_rays(cc19, (pix19 % 128).float(), (pix19 // 128).float(),
                                     (s19 % 2).float(), (s19 // 2).float(), u_gen)
            a19 = (coffee, Vec3(*o19.unbind(1)), Vec3(*d19.unbind(1)), ids19,
                   rng.fold_in(key, 1), depth)
            kname, run = "pt_megakernel_walk", lambda: pk.pt_megakernel(*a19)
        else:
            o19, d19, ids19 = jnp_raygen(cc19, pix19, s19, key, torch.float32)
            a19 = (coffee, Vec3(*o19.unbind(1)), Vec3(*d19.unbind(1)), ids19, key, depth)
            kname, run = "bdpt_megakernel_walk", lambda: bk.bdpt_megakernel(*a19)
        walk_ms[kname] = time_ms(run, reps=3)
        c19 = counters(run())
        walk_bound[kname] = bound(int(ids19.shape[0]) * (7 * 4 + 3 * 4)
                                  + walk_table_bytes(coffee, bdpt=name != "pt"),
                                  c19[-4] * SLAB_OPS + c19[-2] * MT_OPS)
        walk_launches[kname] = n_mk
        del r19, fb
    lap("phase 19")

    # ---- phase 20: the clustered kernels (Pallas kernels 10-13) vs their plain versions
    from bpt_tpu_torch.ops.clusters import cluster_tables
    from bpt_tpu_torch.ops.kernels import cluster_wave as cw
    from bpt_tpu_torch.ops.kernels import plucker as kp
    from bpt_tpu_torch.ops.plucker import plucker_tables

    clustered = {  # name: (module, kernel, plain version)
        "clustered_closest": (cw, cw.clustered_closest, cw.clustered_closest_plain),
        "clustered_any": (cw, cw.clustered_any, cw.clustered_any_plain),
        "plucker_closest": (kp, kp.plucker_closest, kp.plucker_closest_plain),
        "plucker_any": (kp, kp.plucker_any, kp.plucker_any_plain),
    }
    cl_kernels = tuple(v[1] for v in clustered.values())
    cl_plains = tuple(v[2] for v in clustered.values())
    # the rolled kernels' tables; the Plücker ones' come from plucker_*_needs
    cl_tab = sum(t.numel() * t.element_size() for t in cluster_tables(coffee)[:2])
    B = 65536
    o_p, d_p, _ = wave_rays(ccc, torch.arange(B, device=dev) * 4, 1, key, dev)
    lo, hi = (x.cpu().numpy() for x in (coffee.bvh_min[0], coffee.bvh_max[0]))
    o_r = Vec3(*torch.from_numpy(g.uniform(lo, hi, (B, 3)).astype(np.float32)).to(dev).unbind(1))
    d_r = Vec3(*torch.from_numpy(g.normal(size=(B, 3)).astype(np.float32)).to(dev).unbind(1))
    tmin_r = np.where(g.uniform(size=B) < 0.5, g.uniform(0.0, 0.1, B), T_MIN).astype(np.float32)
    tmax_r = (tmin_r + g.uniform(0.0, float(np.linalg.norm(hi - lo)), B)).astype(np.float32)
    tmax_r[::7] = np.inf
    tmax_r[::8] = 0.0  # one lane in eight dead
    lane_sets = {"primary": (o_p, d_p, torch.full((B,), T_MIN, device=dev),
                             torch.full((B,), math.inf, device=dev)),
                 "random": (o_r, d_r, torch.from_numpy(tmin_r).to(dev),
                            torch.from_numpy(tmax_r).to(dev))}
    cl_res = {}
    for name, (_, kern, plain_fn) in clustered.items():
        res20 = cl_res[name] = {"general_frac": 1.0, "general_err": 0.0}
        for lset, args in lane_sets.items():
            kout = kern(coffee, *args)
            pout, p_ms = timed(lambda: plain_fn(coffee, *args))
            kc, pc = kout[-1].tolist(), pout[-1].tolist()
            frac, err, hits = cl_agreement(kout, pout)
            print(f"phase 20: {name} on {B} coffee {lset} rays: equal on {frac * 100:.4f}% of "
                  f"lanes ({hits} hits), max abs err {err:.3e}; counters (slab tests, boxes "
                  f"entered, tri tests, accepted tests) kernel {kc} plain {pc}; plain "
                  f"{p_ms:.3f} ms")
            check(frac >= MIN_FRAC and err <= 1e-6, f"{name} {lset}: only {frac:.5f} of lanes "
                  f"agree, max abs err {err:.3e}")
            check(kc == pc, f"{name} {lset}: counters differ from the plain version")
            res20["general_frac"] = min(res20["general_frac"], frac)
            res20["general_err"] = max(res20["general_err"], err)
            if lset == "primary":
                res20["primaries_plain_ms"] = p_ms
                res20["primaries_ms"] = time_ms(lambda: kern(coffee, *args), reps=5)
        print(f"phase 20: {name} primary rays B={B}: kernel {res20['primaries_ms']:.3f} ms, "
              f"plain {res20['primaries_plain_ms']:.3f} ms ({card})")
    del lane_sets, o_r, d_r
    lap("phase 20")

    # ---- phase 21: the coffee bdpt-mis main path under BPT_TPU_NO_FTB and
    # BPT_TPU_WAVE_IMPL=plucker: kernels 10-11, then 12-13
    cfg21 = coffee_camera(spp=4, integrator="bdpt-mis")
    strata, span = _bdpt_wave_shape(512 * 512, 4, depth, True)
    waves = math.ceil(4 / strata) * math.ceil(512 * 512 / span)
    def_rays, def_shadow, def_fb = default_mis
    pix21 = torch.arange(0, 512 * 512, 257, device=dev).repeat(4)
    s21 = torch.arange(4, device=dev).repeat_interleave(pix21.numel() // 4)
    o21, d21, ids21 = jnp_raygen(ccb, pix21, s21, key, torch.float32)
    bvh_sub = CPU_COFFEE_BDPT_SUBSET["bdpt-mis"][0]
    for impl, var, val, closest_name, any_name in (
            ("rolled", "BPT_TPU_NO_FTB", "1", "clustered_closest", "clustered_any"),
            ("plucker", "BPT_TPU_WAVE_IMPL", "plucker", "plucker_closest", "plucker_any")):
        mod, kc21, _ = clustered[closest_name]
        ka21 = clustered[any_name][1]
        os.environ[var] = val
        try:
            with capture(mod, closest_name, keep={1}) as cl21, \
                    capture(mod, any_name, keep={1}) as an21:
                render(coffee, cfg21, seed=0)  # warm-up; records camera bounce 1, its shadow wave
            sub21 = [int(x) for x in bdpt_jnp(coffee, o21, d21, ids21, key, depth,
                                              mis=True)[1][:2]]
            for fn in (*all_plains, *cl_plains):
                fn.calls = 0
            for fn in (*everything, *tri_kernels, *cl_kernels):
                fn.launches = 0
            torch.cuda.reset_peak_memory_stats(dev)
            r21 = [render(coffee, cfg21, seed=0) for _ in range(3)]
            peak = torch.cuda.max_memory_allocated(dev)
        finally:
            del os.environ[var]
        n_c, n_a = kc21.launches, ka21.launches
        n_other = sum(fn.launches for fn in (*everything, *tri_kernels, *cl_kernels)) - n_c - n_a
        n_plain = sum(fn.calls for fn in (*all_plains, *cl_plains))
        check(n_c == 3 * waves * (2 * depth - 1) and n_a == 3 * waves * depth,
              f"coffee bdpt-mis {impl}: {n_c} {closest_name} and {n_a} {any_name} launches in "
              f"3 renders of {waves} waves")
        check(n_other == 0 and n_plain == 0,
              f"coffee bdpt-mis {impl}: {n_other} other launches, {n_plain} plain calls")
        fb = r21[0].framebuffer_sum
        st = r21[0].stats
        check(bool(np.isfinite(fb).all()) and float(fb.mean()) > 0.0
              and all(np.array_equal(r.framebuffer_sum, fb) for r in r21[1:]),
              f"coffee bdpt-mis {impl}: image non-finite, black or not deterministic")
        gap = (st.rays_traced - def_rays) / def_rays
        walls = [r.stats.wall_seconds for r in r21]
        wall = statistics.median(walls)
        n_diff = int((fb != def_fb).any(axis=-1).sum())
        # bpt_tpu's cluster boxes are the triangles' unpadded bounds, so a
        # cluster flat in one axis is never entered (ROADMAP §3): the route
        # counts its own rays, held against bpt_tpu's route for it on the
        # pixel subset, and the whole image against the default route's
        # count scaled by the two routes' ratio on that subset
        ref, plain_ref = CPU_CLUSTERED_COFFEE_SUBSET[impl], CPU_PLAIN_CLUSTERED_COFFEE[impl]
        sub_gaps = [(a - b) / b * 100 for a, b in zip(sub21, ref)]
        scaled = def_rays * ref[0] / bvh_sub
        scaled_gap = (st.rays_traced - scaled) / scaled * 100
        print(f"phase 21: render coffee bdpt-mis 512x512 4 spp depth {depth} seed 0 with "
              f"{var}={val}: walls {[round(w, 6) for w in walls]} s, median {wall:.6f} s, "
              f"{st.rays_traced / wall / 1e6:.3f} Mrays/s; rays_traced {st.rays_traced} "
              f"({gap * 100:+.4f}% from the default route's {def_rays}; {scaled_gap:+.4f}% "
              f"from that count scaled by bpt_tpu's route / BVH ratio on the subset, "
              f"{scaled:.0f}; TPU bench {TPU_BENCH_COFFEE_BDPT_MIS[0]}, "
              f"{(st.rays_traced / TPU_BENCH_COFFEE_BDPT_MIS[0] - 1) * 100:+.4f}%, not a "
              f"target), shadow_rays {st.shadow_rays} (default {def_shadow}); every 257th "
              f"pixel: rays {sub21[0]}, shadow {sub21[1]} (bpt_tpu's route on a CPU {ref[0]}, "
              f"{ref[1]}: {sub_gaps[0]:+.4f}%, {sub_gaps[1]:+.4f}%; the port's plain route on "
              f"a CPU {plain_ref[0]}, {plain_ref[1]}); {n_diff} of {512 * 512} pixels differ "
              f"from the default route's image; peak device memory {peak / 2**30:.2f} GiB; "
              f"{closest_name} {n_c} and {any_name} {n_a} launches, other launches "
              f"{n_other}, plain calls {n_plain} ({card})")
        check(abs(sub_gaps[0]) <= 0.1 and abs(sub_gaps[1]) <= 1.0,
              f"coffee bdpt-mis {impl}: subset rays / shadow rays {sub21} not within 0.1% / "
              f"1% of bpt_tpu's {ref}")
        check(abs(scaled_gap) <= 1.0, f"coffee bdpt-mis {impl}: rays_traced {st.rays_traced} "
              f"not within 1% of {scaled:.0f}")
        del r21, fb
        # each kernel timed at the main path's own shapes, and held against
        # its plain version on those inputs: every 4th lane of camera bounce
        # 1, every lane of the shadow wave (the plain versions work on live
        # lanes only, and that wave's are its first 1.5%)
        for name, kern, calls, what, stride in (
                (closest_name, kc21, cl21, "camera bounce 1", 4),
                (any_name, ka21, an21, "the shadow wave of camera vertex 1", 1)):
            args, kw = calls[1]
            Bm = int(args[-1].shape[0])
            live = int((args[-1] > 0).sum())
            ms21 = time_ms(lambda: kern(*args, **kw), reps=3)
            full = kern(*args, **kw)
            c21 = full[-1].tolist()
            sl = torch.arange(0, Bm, stride, device=dev)
            s_args = (args[0], *(Vec3(*(x[sl] for x in v)) for v in args[1:3]),
                      *(x[sl] for x in args[3:5]))
            kout = kern(*s_args)
            check(all(torch.equal(a[sl], b) for a, b in zip(full[:-1], kout[:-1])),
                  f"{name}: its launch on every {stride}th lane of {what} differs from the "
                  f"whole launch on those lanes")
            pout, p_ms = timed(lambda: clustered[name][2](*s_args))
            kc, pc = kout[-1].tolist(), pout[-1].tolist()
            frac, err, hits = cl_agreement(kout, pout)
            n_sl, live_sl = int(sl.numel()), int((s_args[-1] > 0).sum())
            res = cl_res[name]
            res.update(ms=ms21, launches=n_c if name == closest_name else n_a, B=Bm,
                       shape=f"{what} of the bdpt-mis wave, B={Bm} ({live} live)",
                       launches_path=f"three coffee bdpt-mis renders with {var}={val}, 512x512, "
                                     f"4 spp, depth {depth}",
                       frac=frac, err=err, plain_ms=p_ms,
                       plain_shape=f"every {stride}th lane of {what}, {n_sl} lanes "
                                   f"({live_sl} live)" if stride > 1 else
                                   f"{what}, all {n_sl} lanes ({live_sl} live)")
            aabb = plucker_tables(coffee).aabb
            if name == "plucker_closest":
                slabs, tab = plucker_closest_needs(aabb, args[1], args[2], args[-1], full[0])
            elif name == "plucker_any":  # the lanes' first hits from the plain traversal
                slabs, tab = plucker_any_needs(aabb, args[1], args[2], args[-1],
                                               kp._plucker(*args, any_hit=True).tri)
            else:
                slabs, tab = None, cl_tab
            res["bound"] = cluster_bound(name, c21, Bm, live, tab, slabs)
            needs = "" if slabs is None else f", {slabs} slab tests needed"
            print(f"phase 21: {name}, {what} (B={Bm}, {live} live): kernel {ms21:.3f} ms, "
                  f"bound {res['bound'][0]:.4f} ms ({res['bound'][1]}); counters {c21}{needs}; "
                  f"against "
                  f"its plain version on {res['plain_shape']}: equal on {frac * 100:.4f}% of "
                  f"lanes ({hits} hits), max abs err {err:.3e}, counters kernel {kc} plain "
                  f"{pc}; plain {p_ms:.3f} ms ({card})")
            check(frac >= MIN_FRAC and err <= 1e-6, f"{name} on {what}: only {frac:.5f} of "
                  f"lanes agree with the plain version, max abs err {err:.3e}")
            check(kc == pc, f"{name} on {what}: counters differ from the plain version")
            del full, kout, pout, s_args, sl
        del cl21, an21, args, kw
        lap(f"phase 21 ({impl})")

    # ---- phase 21b: the warp-wide clustered hits' edge cases, to the bit
    edge21 = cluster_edge_phase(dev, card, coffee)
    lap("phase 21b")

    # ---- phase 22: the refilling wave kernels' edge cases, exact; the brute
    # BDPT kernel's persistent grid; any_bvh's refilling grid
    refill = refill_cases(dev, card)
    brute_pt = brute_pt_cases(dev, card)
    max_err = max(max_err, brute_pt["max_abs_err"])
    brute22 = brute_bdpt_cases(dev, card)
    bdpt_err = max(bdpt_err, brute22["max_abs_err"])
    any22 = any_cases(dev, card)
    lap("phase 22")
    tex = texture_phases(dev, card, coffee, ccc, key, scene_bytes, lap)
    vol = volume_phases(dev, card, key, lap)
    dist25 = distributed_phases(dev, card, refs, coffee, lap)
    f64 = f64_phases(dev, card, lap)
    ns27 = northstar_phase(dev, card, lap)

    # lanes in (pixels: i, j, sx, sy, id; rays: o, d, id), radiance out
    pt_tab = sum(t.numel() * t.element_size() for t in pk._pack_tables(scene))
    bdpt_tab = sum(t.numel() * t.element_size() for t in bk._pack_tables_bdpt(scene))
    pt_bound, pt_by = bound(512 * 512 * 32 + pt_tab, pt_tests * MT_OPS)
    bdpt_bound, bdpt_by = bound(512 * 512 * 24 + bdpt_tab, bdpt_tests * MT_OPS)
    pt_rays_bound = bound(B * 40 + pt_tab, pt_rays_tests * MT_OPS)
    bdpt_rays_bound = bound(B * 40 + bdpt_tab, bdpt_rays_tests * MT_OPS)
    print(f"bounds: pt_megakernel pixels {pt_bound:.4f} ms ({pt_by}), rays "
          f"{pt_rays_bound[0]:.4f} ms ({pt_rays_bound[1]}); bdpt_megakernel pixels "
          f"{bdpt_bound:.4f} ms ({bdpt_by}), rays {bdpt_rays_bound[0]:.4f} ms "
          f"({bdpt_rays_bound[1]})")
    walk_meta = {  # source, replaced Pallas call, launches' path, timed shape
        "pt_megakernel_walk": (
            "pt_megakernel.cu", "pt_kernel.py:1207",
            "three coffee PT renders with defocus, 128x128, 4 spp, depth 10",
            "the PT wave of one such render, 65,536 rays"),
        "pt_megakernel_pixels_walk": (
            "pt_megakernel.cu", "pt_kernel.py:1334",
            "three coffee PT renders through the fused loop, forced (render() takes pt_wave), "
            "256x256, 16 spp, depth 10",
            "one such render's chunk, 65,536 pixels x 16 spp"),
        "bdpt_megakernel_walk": (
            "bdpt_megakernel.cu", "bdpt_kernel.py:1195",
            "three coffee bdpt renders with defocus, 128x128, 4 spp, depth 10",
            "the bdpt wave of one such render, 65,536 rays"),
        "bdpt_megakernel_pixels_walk": (
            "bdpt_megakernel.cu", "bdpt_kernel.py:1314",
            "three coffee bdpt-mis renders, 512x512, 4 spp, depth 80",
            "one such render's chunk, 262,144 pixels x 4 spp"),
    }
    walk_entries = [{
        "name": k,
        "route": "cuda",
        "source": f"bpt_tpu_torch/csrc/{src}",
        "replaces": f"bpt_tpu/ops/pallas/{tpu} (clustered mode)",
        "launches": walk_launches[k],
        "launches_path": path_,
        "max_abs_err": walk_err[k],
        "within_tol": walk_frac[k],
        "ms": walk_ms[k],
        "plain_ms": walk_plain[k],
        "bound_ms": walk_bound[k][0],
        "bound_by": walk_bound[k][1],
        "library_ms": None,
        "shape": shape,
        "plain_shape": walk_plain_shape[k],
        "slice_ms": walk_slice_ms[k],
    } for k, (src, tpu, path_, shape) in walk_meta.items()]
    walk_entries[-1].update(depth80_64x64_ms=walk_d80_ms, persistent_blocks=grid16,
                            scratch_bytes=bk.walk_scratch_bytes(grid16 * pk.WALK_BLOCK, 80,
                                                                True))
    cl_ptx = cluster_ptxas(build.library_path().with_suffix(".log").read_text().splitlines())
    with torch.cuda.device(dev):  # the clustered hits' persistent grids
        lib = build.load_library()
        cl_grid = {"clustered_closest": lib.bpt_clustered_blocks(),
                   "plucker_closest": lib.bpt_plucker_blocks(),
                   "clustered_any": lib.bpt_clustered_any_blocks(),
                   "plucker_any": lib.bpt_plucker_any_blocks()}
    cl_replaces = {"clustered_closest": "cluster_wave.py:212", "clustered_any": "cluster_wave.py:254",
                   "plucker_closest": "plucker.py:332", "plucker_any": "plucker.py:364"}
    cl_entries = [{
        "name": k,
        "route": "cuda",
        "source": f"bpt_tpu_torch/csrc/{'plucker' if k.startswith('plucker') else 'cluster_wave'}.cu",
        "replaces": f"bpt_tpu/ops/pallas/{cl_replaces[k]}",
        "launches": r["launches"],
        "launches_path": r["launches_path"],
        "max_abs_err": r["err"],
        "within_tol": r["frac"],
        "ms": r["ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound"][0],
        "bound_by": r["bound"][1],
        "library_ms": None,
        "shape": r["shape"],
        "plain_shape": r["plain_shape"],
        "primaries_65536_ms": r["primaries_ms"],
        "primaries_65536_plain_ms": r["primaries_plain_ms"],
        "general_interval_within_tol": r["general_frac"],
        "general_interval_max_abs_err": r["general_err"],
        "registers": cl_ptx.get(k, {}).get("registers"),
        "spill_bytes": cl_ptx.get(k, {}).get("spill_bytes"),
        "grid_blocks": cl_grid[k],
        "edge_cases": edge21[k],
    } for k, r in cl_res.items()]
    def defocus_keys(name):
        r = res13[name]
        return {"defocus_wave_ms": r["ms"], "defocus_wave_bound_ms": r["bound"][0],
                "defocus_wave_bound_by": r["bound"][1],
                "defocus_wave_shape": f"the cornell defocus {name} wave, rays mode, B={r['B']}",
                "defocus_wave_within_tol": r["frac"], "defocus_wave_max_abs_err": r["err"],
                "defocus_wave_plain_ms": r["plain_ms"],
                "defocus_wave_plain_shape": f"every 16th lane of that wave, {r['lanes']} lanes"}

    kernels = [{
        "name": "pt_megakernel",
        "route": "cuda",
        "source": "bpt_tpu_torch/csrc/pt_megakernel.cu",
        "replaces": "bpt_tpu/ops/pallas/pt_kernel.py:1334",
        "launches": launches,
        "max_abs_err": max_err,
        "within_tol": frac,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": pt_bound,
        "bound_by": pt_by,
        "library_ms": None,
        "rays_mode_ms": rays_ms,
        "rays_mode_plain_ms": rays_plain_ms,
        "rays_mode_bound_ms": pt_rays_bound[0],
        "rays_mode_launches": rays_mode_launches["pt"],
        "rays_mode_launches_path": "three cornell PT renders with defocus, 512x512, 16 spp, "
                                   "depth 10",
        **defocus_keys("pt"),
        "persistent_blocks": brute_pt["blocks"],
        "edge_cases": brute_pt["cases"],
        **northstar_keys(ns27, "pt"),
    }, {
        "name": "strata_sum",
        "route": "cuda",
        "source": "bpt_tpu_torch/csrc/strata_sum.cu",
        "replaces": "bpt_tpu/ops/pallas/pt_kernel.py:898 (pt_megakernel_pixels' flush of a "
                    "sample into its pixel total; pallas_call :1334)",
        "launches": sum_launches,
        "launches_path": "three cornell PT renders, 512x512, 16 spp, depth 10",
        "max_abs_err": sum_err,
        "within_tol": 1.0,
        "ms": sum_ms,
        "plain_ms": sum_plain_ms,
        "bound_ms": sum_bound[0],
        "bound_by": sum_bound[1],
        "library_ms": sum_lib_ms,
        "library_call": "torch.sum(rows, dim=1): the same sum in its own add order",
        "shape": "the cornell PT render's per-sample radiance, [3, 16, 262144]",
    }, {
        "name": "bdpt_megakernel",
        "route": "cuda",
        "source": "bpt_tpu_torch/csrc/bdpt_megakernel.cu",
        "replaces": "bpt_tpu/ops/pallas/bdpt_kernel.py:1314",
        "launches": bdpt_launches,
        "max_abs_err": bdpt_err,
        "within_tol": bdpt_frac,
        "ms": bdpt_ms["bdpt"],
        "plain_ms": bdpt_plain_ms["bdpt"],
        "bound_ms": bdpt_bound,
        "bound_by": bdpt_by,
        "library_ms": None,
        "mis_ms": bdpt_ms["bdpt-mis"],
        "mis_plain_ms": bdpt_plain_ms["bdpt-mis"],
        "rays_mode_ms": bdpt_rays_ms,
        "rays_mode_plain_ms": bdpt_rays_plain_ms,
        "rays_mode_bound_ms": bdpt_rays_bound[0],
        "rays_mode_launches": rays_mode_launches["bdpt"],
        "rays_mode_launches_path": "three cornell BDPT renders with defocus, 512x512, 16 spp, "
                                   "depth 10",
        "depth80_ms": d80_ms,
        "render_ms": bdpt_ms["bdpt"],
        "render_launches": [{"live": 512 * 512, "ms": bdpt_ms["bdpt"]}],
        "render_shape": "the one launch of a cornell bdpt render, 512x512, 16 spp, depth 10",
        **defocus_keys("bdpt"),
        "persistent_blocks": brute22["blocks"],
        "edge_cases": brute22["cases"],
        **northstar_keys(ns27, "bdpt", "bdpt-mis"),
    }, {
        "name": "closest_bvh",
        "route": "cuda",
        "source": "bpt_tpu_torch/csrc/pt_wave.cu",
        "replaces": "bpt_tpu/ops/pallas/cluster_wave.py:340",
        "launches": closest_main,
        "launches_path": "three coffee bdpt-mis and three bdpt renders, 512x512, 4 spp, "
                         "depth 10",
        "max_abs_err": a_err,
        "within_tol": a_frac,
        "ms": cm_ms,
        "plain_ms": cm_plain_ms,
        "bound_ms": cm_bound,
        "bound_by": cm_by,
        "library_ms": None,
        "shape": f"camera bounce 1 of the bdpt-mis wave, B={Bc}",
        "render_ms": cm_render_ms,
        "render_bound_ms": cm_render_bound,
        "render_launches": [{"live": n, "ms": ms} for n, ms, _ in cm_render],
        "render_shape": "the 19 launches of one coffee bdpt-mis render, 512x512, 4 spp, "
                        "depth 10, each on its own inputs",
        "persistent_blocks": refill["blocks"],
        "refill_cases": refill["cases"],
        "primaries_65536_ms": a_ms,
        "primaries_65536_plain_ms": a_plain_primary_ms,
        "primaries_65536_bound_ms": a_bound,
    }, {
        "name": "any_bvh",
        "route": "cuda",
        "source": "bpt_tpu_torch/csrc/pt_wave.cu",
        "replaces": "bpt_tpu/ops/pallas/cluster_wave.py:397",
        "launches": any_main,
        "launches_path": "three coffee bdpt-mis and three bdpt renders, 512x512, 4 spp, "
                         "depth 10",
        "max_abs_err": any_err,
        "within_tol": am_frac,
        "ms": am_ms,
        "plain_ms": am_plain_ms,
        "bound_ms": am_bound,
        "bound_by": am_by,
        "library_ms": None,
        "shape": f"the bdpt-mis wave's shadow wave of camera vertex 1, B={Bs}",
        "render_ms": am_render_ms,
        "render_bound_ms": am_render_bound,
        "render_launches": [{"live": n, "ms": ms} for n, ms in am_render],
        "render_shape": "the 10 launches of one coffee bdpt-mis render, 512x512, 4 spp, "
                        "depth 10, each on its own inputs",
        "persistent_blocks": any22["blocks"],
        "refill_cases": any22["cases"],
        "mixed_65536_ms": s_ms,
        "mixed_65536_plain_ms": s_plain_ms,
        "mixed_65536_bound_ms": s_bound,
    }, {
        "name": "pt_wave_bounce",
        "route": "cuda",
        "source": "bpt_tpu_torch/csrc/pt_wave.cu",
        "replaces": "bpt_tpu/ops/pallas/pt_wave.py:326",
        "launches": wave_launches,
        "max_abs_err": wave_err,
        "within_tol": wave_frac,
        "ms": b_ms,
        "plain_ms": b_plain_ms,
        "bound_ms": b_bound,
        "bound_by": b_by,
        "library_ms": None,
        "shape": f"the coffee PT render's first bounce, B={b_lanes}",
        "render_ms": b_render_ms,
        "render_bound_ms": b_render_bound,
        "render_launches": [{"live": n, "ms": ms} for n, ms, _ in b_render],
        "render_shape": "the 10 launches of one coffee PT render, 512x512, 16 spp, depth 10, "
                        "each on its own inputs",
        "walk_launches": pt_walk_launches,
        "walk_launches_note": "a bounce is two launches: closest_bvh's walk of the live "
                              "rays, then this kernel's shade; ms, render_ms and plain_ms "
                              "cover both, shade_ms the shade alone",
        "shade_ms": b_shade_ms,
        "refill_cases": refill["cases"],
        "pt_wave_ms": wave_ms[False],
        "pt_wave_paged_ms": wave_ms[True],
        "pt_wave_plain_ms": wave_plain_ms,
        **{k: v for k, v in tex.items() if not k.startswith(("brute_", "earth_"))},
    }, {
        "name": "closest_tri",
        "route": "cuda",
        "source": "bpt_tpu_torch/csrc/intersect.cu",
        "replaces": "bpt_tpu/ops/pallas/intersect.py:172",
        "launches": tri_launches[0],
        "launches_path": "three cornell ref_vis BDPT renders, 256x256, 64 spp, depth 10",
        "max_abs_err": tri_err,
        "within_tol": tri_frac,
        "ms": ct_ms,
        "plain_ms": ct_plain_ms,
        "bound_ms": ct_bound,
        "bound_by": ct_by,
        "library_ms": None,
        "shape": f"camera bounce 1 of the ref_vis wave, B={Bt_c}",
        "live": live_c,
        "plain_shape": f"its every 4th lane, {ct_n} lanes",
        "slice_ms": ct_sl_ms,
        "render_ms": ct_render_ms,
        "render_bound_ms": sum(x[3] for x in ct_render),
        "render_launches": [{"B": b, "live": n, "ms": ms} for b, n, ms, _ in ct_render],
        "render_shape": "the 19 launches of one ref_vis render, 256x256, 64 spp, depth 10, "
                        "each on its own inputs",
        "persistent_blocks": tri_grids[0],
        "textured_wave_launches": tex["brute_wave_closest_tri_launches"],
        "textured_wave_path": "textured pt_wave on a 40-triangle scene without a BVH, "
                              "B=65536, depth 4 (phase 23b)",
        "textured_wave_ms": tex["brute_wave_ms"],
        "textured_wave_plain_ms": tex["brute_wave_plain_ms"],
    }, {
        "name": "any_tri",
        "route": "cuda",
        "source": "bpt_tpu_torch/csrc/intersect.cu",
        "replaces": "bpt_tpu/ops/pallas/intersect.py:214",
        "launches": tri_launches[1],
        "launches_path": "three cornell ref_vis BDPT renders, 256x256, 64 spp, depth 10",
        "max_abs_err": tri_err,
        "within_tol": tri_frac,
        "ms": at_ms,
        "plain_ms": at_plain_ms,
        "bound_ms": at_bound,
        "bound_by": at_by,
        "library_ms": None,
        "shape": f"the ref_vis wave's shadow wave of camera vertex 1, B={Bt_s}",
        "live": live_s,
        "live_rows": live_rows,
        "plain_shape": f"its every 40th lane, {at_n} lanes across its ten light rows",
        "slice_ms": at_sl_ms,
        "render_ms": at_render_ms,
        "render_bound_ms": sum(x[3] for x in at_render),
        "render_launches": [{"B": b, "live": n, "ms": ms} for b, n, ms, _ in at_render],
        "render_shape": "the 10 launches of one ref_vis render, 256x256, 64 spp, depth 10, "
                        "each on its own inputs",
        "persistent_blocks": tri_grids[1],
    }, *walk_entries, *cl_entries, *volume_entries(vol), *f64_entries(f64)]
    wrappers25 = {"pt_megakernel": ("pt_megakernel", "pt_megakernel_pixels"),
                  "bdpt_megakernel": ("bdpt_megakernel", "bdpt_megakernel_pixels")}
    for entry in kernels:
        entry["distributed_launches"] = sum(dist25.get(k, 0) for k in
                                            wrappers25.get(entry["name"], (entry["name"],)))
        entry["distributed_launches_path"] = "phase 25: the sharded, two-process and resumed renders"
    print(f"chip_smoke: all phases passed in {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
