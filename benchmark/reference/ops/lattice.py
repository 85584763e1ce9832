"""Shifted-slice boundary and edge reductions over the class-major lattice
face layout (torch port of deftet_tpu/ops/lattice.py).

With faces ordered ``class * r^3 + cell`` (tetgrid.lattice_faces), the
boundary-face test and the per-edge normal-loss sums are contiguous
shifted slices of ``(B, 6|12, r, r, r)`` arrays instead of gathers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _partner_shift(vol_a, vol_b, delta):
    """``out[cell] = vol_b[cell + delta]`` where the partner cell is on the
    grid, else ``vol_a[cell]`` (an invalid slot reads its own occupancy, so
    ``occ_a + occ_b`` is never 1 there)."""
    nz = [(ax, d) for ax, d in enumerate(delta) if d != 0]
    if not nz:
        return vol_b
    if len(nz) != 1:
        raise ValueError(f"face class delta crosses more than one wall: {delta}")
    ax, d = nz[0]
    axis = vol_b.dim() - 3 + ax
    size = vol_b.shape[axis]
    if d == 1:
        return torch.cat([vol_b.narrow(axis, 1, size - 1),
                          vol_a.narrow(axis, size - 1, 1)], dim=axis)
    return torch.cat([vol_a.narrow(axis, 0, 1),
                      vol_b.narrow(axis, 0, size - 1)], dim=axis)


def lattice_boundary_info(occ_bxt: torch.Tensor, face_lattice):
    """(mask (B, 12 r^3), sign (B, 12 r^3)): a face is boundary iff its two
    owners' occupancies sum to exactly 1; sign is -1 where the first owner
    is occupied."""
    r = face_lattice.res
    b = occ_bxt.shape[0]
    occ6 = occ_bxt.reshape(b, 6, r, r, r)
    masks, signs = [], []
    for fc in face_lattice.classes:
        occ_a = occ6[:, fc.first_type]
        occ_b = _partner_shift(occ_a, occ6[:, fc.second_type], fc.delta)
        masks.append((occ_a + occ_b == 1.0).to(torch.float32))
        signs.append(1.0 - 2.0 * occ_a)
    mask = torch.stack(masks, dim=1).reshape(b, -1)
    sign = torch.stack(signs, dim=1).reshape(b, -1)
    return mask, sign


def lattice_edge_quadratics(w_bxf, nx_bxf, ny_bxf, nz_bxf, face_lattice):
    """Per batch ``(sum_e s_w^2 - |s_n|^2, sum_e s_w^2 - s_w)`` over all
    lattice edges from class-major per-face fields (binary ``w``).  The
    slice sums run in the fields' dtype (bf16 on the train path);
    the quadratics accumulate in f32."""
    r = face_lattice.res
    b = w_bxf.shape[0]
    fields = torch.stack([w_bxf, nx_bxf, ny_bxf, nz_bxf], dim=1).reshape(
        b, 4, 12, r, r, r)
    padded = F.pad(fields, (1, 1, 1, 1, 1, 1))
    total = torch.zeros((b,), dtype=torch.float32, device=w_bxf.device)
    count = torch.zeros((b,), dtype=torch.float32, device=w_bxf.device)
    for incidences in face_lattice.edge_incidence:
        s = None
        for fclass, (di, dj, dk) in incidences:
            sl = padded[:, :, fclass,
                        1 + di:2 + di + r,
                        1 + dj:2 + dj + r,
                        1 + dk:2 + dk + r]
            s = sl if s is None else s + sl
        s = s.float()
        s_w, s_nx, s_ny, s_nz = s[:, 0], s[:, 1], s[:, 2], s[:, 3]
        total = total + torch.sum(
            s_w * s_w - (s_nx * s_nx + s_ny * s_ny + s_nz * s_nz),
            dim=(1, 2, 3))
        count = count + torch.sum(s_w * s_w - s_w, dim=(1, 2, 3))
    return total, count
