"""Procedural .obj meshes for the asset pipeline, made from a seed.

The reference's own mesh (datasets/mill.obj) is not in the repository, so
the conversion and the interactive path run on a procedural "town" written
here, under its own name:

- ``n_houses`` houses on a jittered grid, each a box (four quad walls, no
  floor) under a pitched roof (two quad slopes and two gable triangles),
  some turned by a random yaw, wall and roof each one vertex color;
- ``n_blades`` thin blades (one quad each) at random orientations among and
  above the houses, so that every dominant axis and many slanted normals
  occur;
- no ground plane: most columns of the world stay empty, and the renderer's
  occupancy gate resolves on.

The file uses what the reference's parser reads (ObjModel.cs:10-196):
6-component ``v`` lines (vertex colors), quad faces, and relative (negative)
indices for every third house and every blade.  Positions lie on a 1/16 m
grid and colors are k/255 written to six decimals, so the native and the
python parser read the same float32 values and the same color bytes.

    python -m cpuvox_tpu_torch.bench.meshes out.obj [--seed 0]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def _q(v):
    """Positions on the 1/16 grid."""
    return np.round(np.asarray(v, np.float64) * 16.0) / 16.0


def _color(rng) -> np.ndarray:
    return rng.integers(40, 250, 3)


def write_town_obj(path: str, seed: int = 0, n_houses: int = 1000,
                   n_blades: int = 300, cell: float = 25.0,
                   grid: int = 32) -> dict:
    """Write the town to ``path``; returns its counts (houses, blades,
    vertices, faces, triangles)."""
    rng = np.random.default_rng(seed)
    cells = rng.permutation(grid * grid)[:n_houses]
    lines: list[str] = []
    n_v = 0
    n_faces = n_tris = 0

    def vert(p, col):
        nonlocal n_v
        n_v += 1
        lines.append("v {:.4f} {:.4f} {:.4f} {:.6f} {:.6f} {:.6f}".format(
            *p, *(col / 255.0)))
        return n_v

    def face(idx, rel):
        nonlocal n_faces, n_tris
        n_faces += 1
        n_tris += len(idx) - 2
        lines.append("f " + " ".join(str(i - n_v - 1 if rel else i)
                                     for i in idx))

    for h, c in enumerate(cells):
        gx, gz = divmod(int(c), grid)
        w, d = rng.uniform(8.0, 20.0, 2)
        wall_h = rng.uniform(8.0, 48.0)
        roof_h = rng.uniform(2.0, 8.0)
        yaw = rng.uniform(0.0, np.pi) if rng.random() < 0.3 else 0.0
        cx = (gx + 0.5) * cell + rng.uniform(-2.0, 2.0)
        cz = (gz + 0.5) * cell + rng.uniform(-2.0, 2.0)
        rot = np.array([[np.cos(yaw), -np.sin(yaw)],
                        [np.sin(yaw), np.cos(yaw)]])

        def at(u, v, y):
            x, z = rot @ np.array([u, v])
            return _q((cx + x, y, cz + z))

        wall, roof = _color(rng), _color(rng)
        corners = [(-w / 2, -d / 2), (w / 2, -d / 2), (w / 2, d / 2),
                   (-w / 2, d / 2)]
        bottom = [vert(at(u, v, 0.0), wall) for u, v in corners]
        top = [vert(at(u, v, wall_h), wall) for u, v in corners]
        eave = [vert(at(u, v, wall_h), roof) for u, v in corners]
        # the ridge runs along the house's longer side
        if w >= d:
            ridge = [vert(at(-w / 2, 0.0, wall_h + roof_h), roof),
                     vert(at(w / 2, 0.0, wall_h + roof_h), roof)]
            slopes = [(eave[0], eave[1], ridge[1], ridge[0]),
                      (eave[2], eave[3], ridge[0], ridge[1])]
            gables = [(eave[3], eave[0], ridge[0]),
                      (eave[1], eave[2], ridge[1])]
        else:
            ridge = [vert(at(0.0, -d / 2, wall_h + roof_h), roof),
                     vert(at(0.0, d / 2, wall_h + roof_h), roof)]
            slopes = [(eave[1], eave[2], ridge[1], ridge[0]),
                      (eave[3], eave[0], ridge[0], ridge[1])]
            gables = [(eave[0], eave[1], ridge[0]),
                      (eave[2], eave[3], ridge[1])]
        rel = h % 3 == 2
        for k in range(4):
            j = (k + 1) % 4
            face((bottom[k], bottom[j], top[j], top[k]), rel)
        for f in slopes + gables:
            face(f, rel)

    extent = grid * cell
    for _ in range(n_blades):
        axis = rng.standard_normal(3)
        axis /= np.linalg.norm(axis)
        side = np.cross(axis, rng.standard_normal(3))
        side /= np.linalg.norm(side)
        length, width = rng.uniform(10.0, 30.0), rng.uniform(1.0, 2.5)
        center = np.array([rng.uniform(0.1, 0.9) * extent,
                           rng.uniform(6.0, 45.0),
                           rng.uniform(0.1, 0.9) * extent])
        col = _color(rng)
        a, s = axis * length / 2, side * width / 2
        vs = [vert(_q(center + sa * a + ss * s), col)
              for sa, ss in ((-1, -1), (1, -1), (1, 1), (-1, 1))]
        face(vs, True)

    with open(path, "w") as f:
        f.write("# procedural town, seed %d\n" % seed)
        f.write("\n".join(lines))
        f.write("\n")
    return dict(houses=n_houses, blades=n_blades, vertices=n_v,
                faces=n_faces, triangles=n_tris)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    print(write_town_obj(a.path, a.seed), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
