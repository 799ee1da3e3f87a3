"""Built-in scenes: the reference's hardcoded no-arg cornell box
(src/main.cpp:14-60), as ``bpt_tpu.scene.presets`` builds it (lights are
auto-collected from the world's emissive triangles)."""

from __future__ import annotations

import torch

from bpt_tpu_torch.scene.builder import MaterialSpec, SceneBuilder
from bpt_tpu_torch.scene.types import CameraConfig


def cornell_box_builder() -> SceneBuilder:
    b = SceneBuilder()
    red = MaterialSpec.lambertian((0.65, 0.05, 0.05))
    white = MaterialSpec.lambertian((0.73, 0.73, 0.73))
    green = MaterialSpec.lambertian((0.12, 0.45, 0.15))
    light = MaterialSpec.diffuse_light((15.0, 15.0, 15.0))

    b.add_quad((555, 0, 0), (0, 0, 555), (0, 555, 0), green)
    b.add_quad((0, 0, 555), (0, 0, -555), (0, 555, 0), red)
    b.add_quad((0, 555, 0), (555, 0, 0), (0, 0, 555), white)
    b.add_quad((0, 0, 555), (555, 0, 0), (0, 0, -555), white)
    b.add_quad((555, 0, 555), (-555, 0, 0), (0, 555, 0), white)
    b.add_quad((213, 554, 227), (130, 0, 0), (0, 0, 105), light)
    b.add_box((0, 0, 0), (165, 330, 165), white, rotate_y_degrees=15.0,
              translate=(265, 0, 295))
    b.background = (0.0, 0.0, 0.0)
    return b


def cornell_box_camera(
    image_width=800, samples_per_pixel=5, max_depth=10, integrator="bdpt"
) -> CameraConfig:
    # src/main.cpp:42-56
    return CameraConfig(
        aspect_ratio=1.0,
        image_width=image_width,
        samples_per_pixel=samples_per_pixel,
        max_depth=max_depth,
        background=(0.0, 0.0, 0.0),
        vfov=40.0,
        lookfrom=(278.0, 278.0, -800.0),
        lookat=(278.0, 278.0, 0.0),
        vup=(0.0, 1.0, 0.0),
        defocus_angle=0.0,
        file_name="cornell_box.png",
        integrator=integrator,
    )


def cornell_box(dtype=torch.float32, device="cuda", **build_kwargs):
    return cornell_box_builder().build(dtype=dtype, device=device, **build_kwargs)
