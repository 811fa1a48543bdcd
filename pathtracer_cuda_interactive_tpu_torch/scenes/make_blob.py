"""Write ``blob.obj``: a displaced icosphere, the large-scene test mesh.

An icosphere of subdivision level 4 (5,120 triangles, 2,562 vertices) whose
radius is modulated by a smooth analytic function of direction, then scaled
and moved to stand on the floor of ``blob_box.xml``.  No random numbers are
drawn, so the mesh is the same on every run.  Vertex normals are left out:
the OBJ loader computes smooth ones from the faces.

    python pathtracer_cuda_interactive_tpu_torch/scenes/make_blob.py [OUT]
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

LEVEL = 4
CENTER = np.array([-0.25, 0.62, -0.15])
RADIUS = 0.45


def icosphere(level: int):
    """Unit icosphere: (vertices [V, 3] f64, faces [F, 3] i64), faces wound
    counter-clockwise seen from outside."""
    p = (1.0 + 5.0 ** 0.5) / 2.0
    verts = np.array([[-1, p, 0], [1, p, 0], [-1, -p, 0], [1, -p, 0],
                      [0, -1, p], [0, 1, p], [0, -1, -p], [0, 1, -p],
                      [p, 0, -1], [p, 0, 1], [-p, 0, -1], [-p, 0, 1]],
                     np.float64)
    faces = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10],
                      [0, 10, 11], [1, 5, 9], [5, 11, 4], [11, 10, 2],
                      [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2],
                      [3, 2, 6], [3, 6, 8], [3, 8, 9], [4, 9, 5],
                      [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
                     np.int64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    for _ in range(level):
        a, b, c = faces[:, 0], faces[:, 1], faces[:, 2]
        edges = np.sort(np.concatenate([np.stack([a, b], 1),
                                        np.stack([b, c], 1),
                                        np.stack([c, a], 1)]), axis=1)
        uniq, inv = np.unique(edges, axis=0, return_inverse=True)
        mid = 0.5 * (verts[uniq[:, 0]] + verts[uniq[:, 1]])
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        ab, bc, ca = (len(verts) + inv.reshape(3, -1))
        verts = np.concatenate([verts, mid])
        faces = np.concatenate([np.stack([a, ab, ca], 1),
                                np.stack([ab, b, bc], 1),
                                np.stack([ca, bc, c], 1),
                                np.stack([ab, bc, ca], 1)])
    return verts, faces


def blob(level: int = LEVEL):
    """The displaced, placed icosphere: (vertices, faces)."""
    d, faces = icosphere(level)
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    r = (1.0 + 0.22 * np.sin(3.0 * x + 0.4) * np.cos(2.5 * y)
         * np.sin(3.0 * z + 1.1) + 0.08 * np.cos(6.0 * y))
    verts = CENTER + RADIUS * r[:, None] * d
    e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    area2 = np.linalg.norm(np.cross(e1, e2), axis=1)
    assert area2.min() > 1e-6, "degenerate triangle"
    assert verts[:, 1].min() > 0.0, "the blob must stay above the floor"
    return verts, faces


def write_obj(path: Path, verts: np.ndarray, faces: np.ndarray) -> None:
    lines = [f"# displaced icosphere, level {LEVEL}: {len(verts)} vertices, "
             f"{len(faces)} triangles (scenes/make_blob.py)"]
    lines += [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in verts]
    lines += [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in faces]
    path.write_text("\n".join(lines) + "\n")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out = Path(argv[0]) if argv else Path(__file__).resolve().parent / "blob.obj"
    verts, faces = blob()
    write_obj(out, verts, faces)
    print(f"wrote {out}: {len(verts)} vertices, {len(faces)} triangles")
    return 0


if __name__ == "__main__":
    sys.exit(main())
