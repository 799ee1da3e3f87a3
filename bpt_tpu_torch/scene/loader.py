"""YAML scene loader, counterpart of ``bpt_tpu.scene.loader`` (the
reference loader, src/scene/scene_loader.h:480-523 and helpers), with its
tolerant coercions and synonyms:

* 0-255 color autoscale: any component >1 and max<=255 -> /255
  (scene_loader.h:81-92); emission via the ``type: light`` path is exempt
  (scene_loader.h:122-125)
* material schema type: lambertian|metal|dielectric|glass|light|diffuse_light
  (scene_loader.h:112-135) + the legacy PBR mapping (scene_loader.h:140-169)
* surfaces: TriMesh (flat 9-float triples), Sphere (16x32 UV tessellation),
  mesh (indexed, 0-based), object (OBJ file); unknown type -> warn + skip
  (scene_loader.h:500-519); ``surfaces:`` with ``scene:`` fallback key
* camera: resolution (required), fov/vfov clamped [1,179], focus_distance,
  location/look_at/up/background, samples_per_pixel, max_depth, output;
  defocus force-disabled (scene_loader.h:427-476)
* bpt_tpu's ``texture`` sub-map on a material (image, checker, noise), with
  image paths relative to the YAML's directory
* bpt_tpu's constant-density volumes: ``volume_box`` (rotate_y, translate)
  and ``volume_sphere`` surfaces with a density, an albedo and an optional
  ``texture`` sub-map (bpt_tpu/scene/loader.py:316-360)

PyYAML is imported inside ``load_scene_from_yaml``, so the rest of the
package never needs it.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from dataclasses import dataclass

import torch

from bpt_tpu_torch.scene.builder import MaterialSpec, SceneBuilder
from bpt_tpu_torch.scene.textures import TextureSpec
from bpt_tpu_torch.scene.types import CameraConfig, SceneTensors


@dataclass
class LoadedScene:
    camera: CameraConfig
    scene: SceneTensors
    builder: SceneBuilder


# ----------------------------------------------------------- YAML coercion
# node_to_* tolerate junk exactly like the reference (scene_loader.h:32-71)


def _to_str(node, default=""):
    if isinstance(node, (str, int, float, bool)):
        return str(node)
    return default


def _to_float(node, default=0.0):
    if isinstance(node, bool):
        return default
    if isinstance(node, (int, float)):
        return float(node)
    if isinstance(node, str):
        try:
            return float(node)
        except ValueError:
            return default
    return default


def _to_int(node, default=0):
    if isinstance(node, bool):
        return default
    if isinstance(node, int):
        return node
    if isinstance(node, (float, str)):
        try:
            return int(float(node))
        except ValueError:
            return default
    return default


def _to_float_list(node):
    if not isinstance(node, (list, tuple)):
        return []
    return [_to_float(x, 0.0) for x in node]


def read_color(node, fallback):
    vals = _to_float_list(node)
    if len(vals) < 3:
        return tuple(fallback)
    return (vals[0], vals[1], vals[2])


def read_color_scaled(node, fallback):
    """0-255 autoscale heuristic (scene_loader.h:81-92)."""
    vals = _to_float_list(node)
    if len(vals) < 3:
        return tuple(fallback)
    r, g, b = vals[0], vals[1], vals[2]
    maxc = max(abs(r), abs(g), abs(b))
    if 1.0 < maxc <= 255.0:
        s = 1.0 / 255.0
        r, g, b = r * s, g * s, b * s
    return (r, g, b)


read_vec3 = read_color


# ------------------------------------------------------------- materials


def _build_texture(node, yaml_dir):
    """bpt_tpu's texture sub-map of a material (bpt_tpu/scene/loader.py:
    120-146): ``{type: image, file: path}`` (relative to the YAML's
    directory), ``{type: checker, scale, even, odd}`` or ``{type: noise,
    scale}``; anything else is no texture."""
    if not isinstance(node, dict):
        return None
    ttype = _to_str(node.get("type"))
    if ttype == "image":
        path = _to_str(node.get("file"))
        if not path:
            return None
        if not os.path.isabs(path):
            path = os.path.join(yaml_dir, path)
        return TextureSpec.image(path)
    if ttype == "checker":
        return TextureSpec.checker(
            _to_float(node.get("scale"), 1.0),
            read_color_scaled(node.get("even"), (0, 0, 0)),
            read_color_scaled(node.get("odd"), (1, 1, 1)),
        )
    if ttype == "noise":
        return TextureSpec.noise(_to_float(node.get("scale"), 1.0))
    return None


def build_material(node, yaml_dir="") -> MaterialSpec:
    """build_material (scene_loader.h:101-170), with bpt_tpu's texture
    sub-map on lights, lambertians and the legacy mapping's lights and
    diffuse surfaces."""
    if not isinstance(node, dict):
        raise ValueError("Material must be a mapping")

    default_color = (0.0, 0.0, 0.0)
    texture = _build_texture(node.get("texture"), yaml_dir)
    type_str = _to_str(node.get("type"))

    if type_str:
        color_value = read_color_scaled(
            node.get("color"),
            read_color_scaled(
                node.get("albedo"),
                read_color_scaled(
                    node.get("base_color"),
                    read_color_scaled(node.get("base_colour"), default_color),
                ),
            ),
        )
        if type_str in ("light", "diffuse_light"):
            # linear HDR emission, no 0-255 scaling (scene_loader.h:122-125)
            return MaterialSpec.diffuse_light(read_color(node.get("emission"), default_color),
                                              texture=texture)
        if type_str == "lambertian":
            return MaterialSpec.lambertian(color_value, texture=texture)
        if type_str == "metal":
            roughness = min(max(_to_float(node.get("roughness"), 0.0), 0.0), 1.0)
            return MaterialSpec.metal(color_value, roughness)
        if type_str in ("dielectric", "glass"):
            ior = _to_float(node.get("ior"), 1.5)
            return MaterialSpec.dielectric(ior if ior > 0.0 else 1.5)
        # unknown type: fall through to legacy mapping (scene_loader.h:135)

    # legacy PBR mapping (scene_loader.h:140-169)
    base_color = read_color_scaled(node.get("base_color"), default_color)
    if node.get("base_colour") is not None:
        base_color = read_color_scaled(node.get("base_colour"), base_color)
    emission = read_color_scaled(node.get("emission"), default_color)

    if sum(c * c for c in emission) > 0.0:
        maxc = max(abs(c) for c in emission)
        if maxc > 50.0:
            emission = tuple(c * (50.0 / maxc) for c in emission)
        return MaterialSpec.diffuse_light(emission, texture=texture)

    transmission = _to_float(node.get("transmission"), 0.0)
    if transmission == 0.0:
        transmission = _to_float(node.get("spec_trans"), 0.0)
    ior = _to_float(node.get("ior"), 1.5)
    if transmission > 0.0:
        return MaterialSpec.dielectric(ior if ior > 0.0 else 1.5)

    metallic = _to_float(node.get("metallic"), 0.0)
    roughness = min(max(_to_float(node.get("roughness"), 0.0), 0.0), 1.0)
    if metallic > 0.5:
        return MaterialSpec.metal(base_color, roughness)

    return MaterialSpec.lambertian(base_color, texture=texture)


def load_materials(node, yaml_dir="") -> dict:
    """name -> MaterialSpec; invalid entries skipped (scene_loader.h:173-188)."""
    out = {}
    if not isinstance(node, dict):
        return out
    for name, mdef in node.items():
        try:
            out[str(name)] = build_material(mdef, yaml_dir)
        except Exception:
            pass
    return out


_DEFAULT_GRAY = MaterialSpec.lambertian((0.8, 0.8, 0.8))  # scene_loader.h:329


def _resolve_material(node, materials, yaml_dir):
    if isinstance(node, str):
        return materials.get(node) or _DEFAULT_GRAY
    if isinstance(node, dict):
        try:
            return build_material(node, yaml_dir)
        except Exception:
            return _DEFAULT_GRAY
    return _DEFAULT_GRAY


# -------------------------------------------------------------- surfaces


def _read_transform(node) -> dict:
    """bpt_tpu's extension ``transform: {rotate_y: deg, translate: [x, y,
    z]}`` (the reference's C++ rotate_y/translate wrappers,
    hittable.h:46-120) as builder kwargs; absent -> identity."""
    t = node.get("transform")
    if not isinstance(t, dict):
        return {}
    return dict(
        rotate_y_degrees=_to_float(t.get("rotate_y"), 0.0),
        translate=read_vec3(t.get("translate"), (0, 0, 0)),
    )


def _load_tri_mesh(mesh, builder, yaml_dir):
    """scene_loader.h:244-272."""
    data = mesh.get("data")
    if not isinstance(data, dict):
        raise ValueError("Mesh missing data field")
    verts = _to_float_list(data.get("vertices"))
    if not isinstance(data.get("vertices"), list):
        raise ValueError("Missing vertices")
    if len(verts) % 9 != 0:
        raise ValueError("Vertices length not a multiple of 9")
    if "material" not in mesh:
        raise ValueError("Missing material field")
    mat = build_material(mesh.get("material"), yaml_dir)
    xf = _read_transform(mesh)
    for i in range(0, len(verts), 9):
        builder.add_triangle(verts[i:i + 3], verts[i + 3:i + 6], verts[i + 6:i + 9], mat, **xf)


def _load_sphere(mesh, builder, yaml_dir):
    """scene_loader.h:274-294."""
    if "material" not in mesh:
        raise ValueError("Missing material field")
    mat = build_material(mesh.get("material"), yaml_dir)
    data = mesh.get("data")
    if not isinstance(data, dict):
        raise ValueError("Missing data field")
    center = read_vec3(data.get("center"), (0, 0, 0))
    radius = _to_float(data.get("radius"), 0.0)
    if radius <= 0.0:
        raise ValueError("Missing or invalid radius field")
    builder.add_uv_sphere(center, radius, mat, **_read_transform(mesh))


def _load_indexed_mesh(mesh, builder, materials, yaml_dir):
    """scene_loader.h:296-343 — 0-based indices, short rows skipped."""
    verts_node = mesh.get("vertices")
    tris_node = mesh.get("triangles")
    if not isinstance(verts_node, list):
        raise ValueError("Indexed mesh missing vertices")
    if not isinstance(tris_node, list):
        raise ValueError("Indexed mesh missing triangles")
    verts = []
    for v in verts_node:
        vals = _to_float_list(v)
        if len(vals) >= 3:
            verts.append(tuple(vals[:3]))
    mat = _resolve_material(mesh.get("material"), materials, yaml_dir)
    xf = _read_transform(mesh)
    for tri in tris_node:
        idx = [_to_int(t, 0) for t in tri] if isinstance(tri, list) else []
        if len(idx) < 3:
            continue
        builder.add_triangle(verts[idx[0]], verts[idx[1]], verts[idx[2]], mat, **xf)


def _load_object(node, yaml_dir, builder, materials):
    """scene_loader.h:399-425; ``smooth: true`` is parsed-then-ignored, as
    in the reference."""
    file_rel = _to_str(node.get("file"))
    if not file_rel:
        raise ValueError("Object missing file field")
    mat = _resolve_material(node.get("material"), materials, yaml_dir)
    builder.add_obj(os.path.join(yaml_dir, file_rel), mat, **_read_transform(node))


def _load_volume(node, builder, yaml_dir):
    """bpt_tpu's volume extension (the reference exposes constant_medium.h
    from C++ only).  Schema:

      - type: volume_box
        data: {min: [x,y,z], max: [x,y,z], rotate_y: deg, translate: [x,y,z]}
        density: 0.01
        albedo: [r, g, b]
        texture: {type: checker|image|noise, ...}   # optional
      - type: volume_sphere
        data: {center: [x,y,z], radius: r}
        density: 0.01
        albedo: [r, g, b]
        texture: {...}
    """
    data = node.get("data")
    if not isinstance(data, dict):
        raise ValueError("Volume missing data field")
    density = _to_float(node.get("density"), 0.0)
    if density <= 0.0:
        raise ValueError("Volume missing or invalid density field")
    albedo = read_color_scaled(node.get("albedo"), (1.0, 1.0, 1.0))
    texture = _build_texture(node.get("texture"), yaml_dir)
    if _to_str(node.get("type")) == "volume_sphere":
        center = read_vec3(data.get("center"), (0, 0, 0))
        radius = _to_float(data.get("radius"), 0.0)
        if radius <= 0.0:
            raise ValueError("Volume sphere missing or invalid radius")
        builder.add_volume_sphere(center, radius, density, albedo, texture=texture)
        return
    lo = read_vec3(data.get("min"), (0, 0, 0))
    hi = read_vec3(data.get("max"), (0, 0, 0))
    if any(h <= l for l, h in zip(lo, hi)):
        raise ValueError("Volume box min/max extents invalid or missing")
    builder.add_volume_box(
        lo, hi, density, albedo,
        rotate_y_degrees=_to_float(data.get("rotate_y"), 0.0),
        translate=read_vec3(data.get("translate"), (0, 0, 0)),
        texture=texture,
    )


# --------------------------------------------------------------- camera


def load_camera(node, overrides=None) -> CameraConfig:
    """load_camera_from_yaml (scene_loader.h:427-476)."""
    if not isinstance(node, dict):
        raise ValueError("Camera section must be a mapping")
    res = _to_float_list(node.get("resolution"))
    if len(res) < 2:
        raise ValueError("Camera missing resolution")
    width, height = int(res[0]), int(res[1])
    if width <= 0 or height <= 0:
        raise ValueError("Resolution values must be positive")

    defaults = CameraConfig()
    vfov = defaults.vfov
    if node.get("vfov") is not None or node.get("fov") is not None:
        vfov = _to_float(node.get("vfov"), _to_float(node.get("fov"), vfov))
    vfov = min(max(vfov, 1.0), 179.0)

    cfg = CameraConfig(
        aspect_ratio=width / height,
        image_width=width,
        samples_per_pixel=_to_int(node.get("samples_per_pixel"), defaults.samples_per_pixel),
        max_depth=_to_int(node.get("max_depth"), defaults.max_depth),
        background=read_color(node.get("background"), defaults.background),
        vfov=vfov,
        lookfrom=read_vec3(node.get("location"), defaults.lookfrom),
        lookat=read_vec3(node.get("look_at"), defaults.lookat),
        vup=read_vec3(node.get("up"), defaults.vup),
        defocus_angle=0.0,  # force-disabled (scene_loader.h:462-463)
        focus_dist=_to_float(node.get("focus_distance"), defaults.focus_dist),
        file_name=_to_str(node.get("output")) or defaults.file_name,
    )
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


# ----------------------------------------------------------------- entry


def load_scene_from_yaml(path, dtype=torch.float32, device="cuda",
                         camera_overrides=None, verbose=True) -> LoadedScene:
    """load_scene_from_yaml (scene_loader.h:480-523); the scene's tensors
    go to ``device``."""
    import yaml

    with open(path, "r") as f:
        root = yaml.safe_load(f)
    if not isinstance(root, dict):
        raise ValueError("Scene root must be a mapping")

    cam = load_camera(root.get("camera"), camera_overrides)
    yaml_dir = os.path.dirname(os.path.abspath(path))
    materials = load_materials(root.get("materials"), yaml_dir)

    surfaces = root.get("surfaces")
    if surfaces is None:
        surfaces = root.get("scene")  # legacy key (scene_loader.h:492-494)
    if not isinstance(surfaces, list):
        raise ValueError("Scene/surfaces field missing or not a sequence")

    builder = SceneBuilder()
    builder.background = tuple(cam.background)

    for mesh in surfaces:
        if not isinstance(mesh, dict):
            raise ValueError("Scene entries must be mappings")
        mesh_type = _to_str(mesh.get("type"))
        if not mesh_type:
            raise ValueError("Mesh missing type field")
        if mesh_type == "TriMesh":
            _load_tri_mesh(mesh, builder, yaml_dir)
        elif mesh_type == "Sphere":
            _load_sphere(mesh, builder, yaml_dir)
        elif mesh_type == "mesh":
            _load_indexed_mesh(mesh, builder, materials, yaml_dir)
        elif mesh_type == "object":
            _load_object(mesh, yaml_dir, builder, materials)
        elif mesh_type in ("volume_box", "volume_sphere"):
            _load_volume(mesh, builder, yaml_dir)
        else:
            print(f"Unknown mesh type: {mesh_type}", file=sys.stderr)

    if verbose:
        print(f"Triangles: {builder.num_tris}")

    scene = builder.build(dtype=dtype, device=device)
    return LoadedScene(camera=cam, scene=scene, builder=builder)
