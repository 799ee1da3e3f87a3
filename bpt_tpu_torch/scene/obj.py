"""Minimal OBJ parser, the Python path of ``bpt_tpu.scene.obj.parse_obj``
(a behavioral clone of the reference's, src/scene/scene_loader.h:345-397):
only 'v' and 'f' lines, face tokens vi | vi/vt | vi/vt/vn | vi//vn (only
vi used), 1-based and negative indices, fan triangulation, malformed
tokens skipped, normals/UVs discarded.  Pure Python: parsing the coffee
stand-in's five files takes a fraction of a second, so the port needs no
native parser.
"""

from __future__ import annotations


def parse_obj(path):
    """Return [(v0, v1, v2)] vertex-position triples."""
    verts: list[tuple] = []
    tris: list[tuple] = []
    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                if len(parts) >= 4:
                    try:
                        verts.append(
                            (float(parts[1]), float(parts[2]), float(parts[3])))
                    except ValueError:
                        pass
            elif tag == "f":
                fidx = []
                for tok in parts[1:]:
                    try:
                        vi = int(tok.split("/", 1)[0])
                    except ValueError:
                        continue  # skip malformed (scene_loader.h:382-384)
                    fidx.append(vi - 1 if vi > 0 else len(verts) + vi)
                for k in range(2, len(fidx)):  # fan (scene_loader.h:386-394)
                    tris.append((verts[fidx[0]], verts[fidx[k - 1]], verts[fidx[k]]))
    return tris
