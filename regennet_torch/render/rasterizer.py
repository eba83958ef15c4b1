"""Z-buffered, flat-shaded triangle rasterizer in PyTorch (counterpart of
regennet_tpu/render/rasterizer.py).

The software stand-in for the reference's GL mesh renderer (pyrender and
OSMesa: a weak-perspective camera, flat-shaded opaque materials, ambient
0.4, the mesh rotated 180 degrees about x). Faces go through in chunks of
`chunk`: each chunk is dense [chunk, pixels] math over the pixels of its
bounding box (edge tests against the signed area, the depth interpolated
at the pixel centres, an argmin over the chunk), merged into a per-pixel
(depth, colour) buffer. The JAX package tests every pixel of the frame;
a pixel outside a chunk's box lies in none of its faces, so the frames
are the same. It runs on the device of its inputs, the GPU's plain
PyTorch kernels or the CPU's, with the same arithmetic as the JAX
package's program in float32.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

DEFAULT_AMBIENT = 0.4
# person 0 ivory, person 1 gray (the reference's two-person materials)
PERSON_MESH_COLORS = ((1.0, 1.0, 0.9), (0.618, 0.618, 0.618),
                      (0.55, 0.71, 0.88), (0.72, 0.53, 0.8))
_FAR = 3e38


def fit_weak_perspective(verts, fill: float = 0.85) -> Tuple[float, float, float, float]:
    """(sx, sy, tx, ty) mapping the vertex cloud `verts` [..., 3] (numpy
    or a tensor, the whole sequence: the camera stays still) into the
    [-fill, fill] box of normalised device coordinates, aspect kept."""
    v = torch.as_tensor(verts).reshape(-1, 3)
    lo, hi = v.min(0).values.cpu().numpy(), v.max(0).values.cpu().numpy()
    center = (lo + hi) / 2
    extent = max(float(hi[0] - lo[0]), float(hi[1] - lo[1]), 1e-6)
    s = 2.0 * fill / extent
    # ndc_x = sx * (x + tx); ndc_y = sy * (y - ty)
    return s, s, -float(center[0]), float(center[1])


def _cross2(a, b):
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def _chunk_boxes(corners, F: int, chunk: int, H: int, W: int) -> np.ndarray:
    """[chunks, 4] pixel boxes (row0, row1, col0, col1; ends exclusive) that
    hold every pixel centre of each chunk's faces, with a pixel to spare on
    each side, clipped to the frame; the whole frame where a corner is not
    finite. One copy to the host."""
    pad = (-F) % chunk
    xy = torch.stack(corners, 1)  # [F, 3, 2]
    lo, hi = xy.amin(1), xy.amax(1)  # [F, 2]
    if pad:
        lo = torch.cat([lo, lo[-1:].expand(pad, 2)])
        hi = torch.cat([hi, hi[-1:].expand(pad, 2)])
    lo = lo.view(-1, chunk, 2).amin(1)
    hi = hi.view(-1, chunk, 2).amax(1)
    box = torch.cat([lo, hi], 1).cpu().numpy().astype(np.float64)  # x0, y0, x1, y1
    out = np.empty((box.shape[0], 4), np.int64)
    finite = np.isfinite(box).all(1)
    box = np.where(finite[:, None], box, 0.0)
    out[:, 0] = np.clip(np.floor(box[:, 1]) - 1, 0, H)
    out[:, 1] = np.clip(np.ceil(box[:, 3]) + 1, 0, H)
    out[:, 2] = np.clip(np.floor(box[:, 0]) - 1, 0, W)
    out[:, 3] = np.clip(np.ceil(box[:, 2]) + 1, 0, W)
    out[~finite] = (0, H, 0, W)
    return out


def rasterize_mesh(verts, faces, face_colors, resolution: Tuple[int, int] = (224, 224),
                   cam: Sequence[float] = (1.0, 1.0, 0.0, 0.0),
                   light_dir: Sequence[float] = (0.25, 0.4, 1.0),
                   ambient: float = DEFAULT_AMBIENT,
                   bg_color: Sequence[float] = (1.0, 1.0, 1.0), chunk: int = 128,
                   device=None) -> torch.Tensor:
    """One frame: view-space verts [V, 3], faces [F, 3] and their base
    colours [F, 3] in [0, 1] -> [H, W, 3] uint8 on `device` (that of
    `verts` when it is a tensor and device is None, else the CPU)."""
    if device is None:
        device = verts.device if torch.is_tensor(verts) else "cpu"
    f32 = dict(dtype=torch.float32, device=device)
    verts = torch.as_tensor(verts, **f32)
    tri = torch.as_tensor(np.asarray(faces), dtype=torch.long, device=device)
    face_colors = torch.as_tensor(face_colors, **f32)
    sx, sy, tx, ty = torch.as_tensor(cam, **f32)
    W, H = resolution
    F = tri.shape[0]
    chunk = max(1, min(chunk, F))

    x = sx * (verts[:, 0] + tx)
    y = sy * (verts[:, 1] - ty)
    depth = -verts[:, 2]  # the camera looks down -z
    px = (x + 1.0) * 0.5 * W
    py = (1.0 - y) * 0.5 * H

    v0, v1, v2 = verts[tri[:, 0]], verts[tri[:, 1]], verts[tri[:, 2]]
    n = torch.linalg.cross(v1 - v0, v2 - v0)
    n = n / (torch.linalg.norm(n, dim=-1, keepdim=True) + 1e-9)
    light = torch.as_tensor(light_dir, **f32)
    light = light / (torch.linalg.norm(light) + 1e-9)
    # |n.l|: either winding shades alike
    amb = torch.tensor(ambient, **f32)
    shade = torch.clamp(amb + (1.0 - amb) * torch.abs(n @ light), 0.0, 1.0)
    lit = face_colors * shade[:, None]

    sxy = torch.stack([px, py], -1)
    corners = [sxy[tri[:, i]] for i in range(3)]
    depths = [depth[tri[:, i]] for i in range(3)]
    ys, xs = torch.meshgrid(torch.arange(H, **f32) + 0.5, torch.arange(W, **f32) + 0.5,
                            indexing="ij")
    grid = torch.stack([xs, ys], -1)  # [H, W, 2] pixel centres

    zbuf = torch.full((H, W), _FAR, **f32)
    cbuf = torch.as_tensor(bg_color, **f32).expand(H, W, 3).clone()
    for i, (r0, r1, c0, c1) in enumerate(_chunk_boxes(corners, F, chunk, H, W)):
        if r0 >= r1 or c0 >= c1:
            continue  # the chunk lies off the frame
        lo = i * chunk
        pix = grid[r0:r1, c0:c1].reshape(1, -1, 2)  # [1, n, 2]
        a, b, c = (p[lo:lo + chunk] for p in corners)
        za, zb, zc = (z[lo:lo + chunk, None] for z in depths)
        area = _cross2(b - a, c - a)[:, None]  # [chunk, 1]
        a, b, c = a[:, None], b[:, None], c[:, None]
        w0 = _cross2(c - b, pix - b)
        w1 = _cross2(a - c, pix - c)
        w2 = _cross2(b - a, pix - a)
        s = torch.sign(area)
        solid = torch.abs(area) > 1e-9
        inside = (w0 * s >= 0) & (w1 * s >= 0) & (w2 * s >= 0) & solid
        inv = 1.0 / torch.where(solid, area, torch.ones_like(area))
        d = torch.where(inside, (w0 * za + w1 * zb + w2 * zc) * inv,
                        torch.full_like(w0, _FAR))
        best = torch.argmin(d, dim=0)  # the first of equal depths
        dbest = d.gather(0, best[None])[0]
        z_in = zbuf[r0:r1, c0:c1].reshape(-1)
        take = dbest < z_in
        zbuf[r0:r1, c0:c1] = torch.where(take, dbest, z_in).view(r1 - r0, c1 - c0)
        c_in = cbuf[r0:r1, c0:c1].reshape(-1, 3)
        cbuf[r0:r1, c0:c1] = torch.where(take[:, None], lit[lo:lo + chunk][best],
                                         c_in).view(r1 - r0, c1 - c0, 3)
    img = torch.clamp(cbuf, 0.0, 1.0)
    return (img * 255.0 + 0.5).to(torch.uint8)


def render_mesh_sequence(vertices, faces, resolution: Tuple[int, int] = (224, 224),
                         colors: Optional[Sequence[Sequence[float]]] = None,
                         bg_color: Sequence[float] = (1.0, 1.0, 1.0),
                         device=None) -> List[np.ndarray]:
    """Persons x time vertices [P, V, 3, T] (numpy or a tensor) and faces
    [F, 3] -> T frames [H, W, 3] uint8, rasterised on `device` (that of
    `vertices` when it is a tensor and device is None, else the CPU). The
    meshes are rotated 180 degrees about x, each person takes its material
    colour, and the weak-perspective camera is fitted once to the whole
    sequence."""
    if device is None:
        device = vertices.device if torch.is_tensor(vertices) else "cpu"
    vertices = torch.as_tensor(vertices, dtype=torch.float32, device=device)
    P, V, _, T = vertices.shape
    faces = np.asarray(faces, np.int64)
    if colors is None:
        colors = [PERSON_MESH_COLORS[p % len(PERSON_MESH_COLORS)] for p in range(P)]
    # Rx(180): (x, y, z) -> (x, -y, -z)
    flipped = torch.stack([vertices[:, :, 0], -vertices[:, :, 1], -vertices[:, :, 2]], dim=2)
    cam = fit_weak_perspective(flipped.permute(0, 1, 3, 2))
    all_faces = np.concatenate([faces + p * V for p in range(P)])
    face_colors = np.concatenate([np.tile(np.asarray(colors[p], np.float32),
                                          (faces.shape[0], 1)) for p in range(P)])
    return [rasterize_mesh(flipped[:, :, :, t].reshape(P * V, 3), all_faces, face_colors,
                           resolution=resolution, cam=cam, bg_color=bg_color).cpu().numpy()
            for t in range(T)]
