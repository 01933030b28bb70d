"""Minimal binary-little-endian PLY writer/reader.

Replaces the open3d TriangleMesh + o3d.io.write_triangle_mesh dependency
(inverse_img_w_mi.py:15,727): the mesh artifact only exists for §2.10
output-layout parity and external tooling — the TPU renderer consumes the
depth map directly.
"""

from __future__ import annotations

import struct

import numpy as np


def write_ply(path: str, vertices: np.ndarray, faces: np.ndarray,
              normals: np.ndarray = None) -> None:
    """vertices (N,3) float, faces (M,3) int, optional normals (N,3)."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.uint32)
    n, m = len(vertices), len(faces)
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0",
               f"element vertex {n}",
               "property float x", "property float y", "property float z"]
        if normals is not None:
            hdr += ["property float nx", "property float ny",
                    "property float nz"]
        hdr += [f"element face {m}",
                "property list uchar uint vertex_indices", "end_header"]
        f.write(("\n".join(hdr) + "\n").encode())
        if normals is not None:
            data = np.hstack([vertices, np.asarray(normals, np.float32)])
        else:
            data = vertices
        f.write(np.ascontiguousarray(data, np.float32).tobytes())
        face_block = np.empty((m, 13), np.uint8)
        face_block[:, 0] = 3
        face_block[:, 1:] = faces.astype("<u4").view(np.uint8).reshape(m, 12)
        f.write(face_block.tobytes())


def read_ply(path: str):
    """Read a binary-LE or ascii PLY (vertices + triangular faces)."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode(errors="replace").splitlines()
    fmt = next(l.split()[1] for l in header if l.startswith("format"))
    counts = {}
    props = {}
    cur = None
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "element":
            cur = parts[1]
            counts[cur] = int(parts[2])
            props[cur] = []
        elif parts[0] == "property" and cur is not None:
            props[cur].append(parts[1:])
    nv = counts.get("vertex", 0)
    nf = counts.get("face", 0)
    vprops = props.get("vertex", [])
    if fmt.startswith("binary_little"):
        sizes = {"float": 4, "float32": 4, "double": 8, "uchar": 1,
                 "uint8": 1, "int": 4, "uint": 4, "int32": 4, "uint32": 4}
        stride = sum(sizes[p[0]] for p in vprops)
        raw = np.frombuffer(data, np.uint8, count=nv * stride, offset=end)
        raw = raw.reshape(nv, stride)
        off = 0
        cols = {}
        for p in vprops:
            name, size = p[1], sizes[p[0]]
            if p[0] in ("float", "float32"):
                cols[name] = raw[:, off:off + 4].copy().view("<f4")[:, 0]
            off += size
        verts = np.stack([cols["x"], cols["y"], cols["z"]], axis=-1)
        fo = end + nv * stride
        faces = np.empty((nf, 3), np.uint32)
        pos = fo
        for i in range(nf):
            cnt = data[pos]
            pos += 1
            tri = struct.unpack_from("<3I", data, pos)
            pos += 4 * cnt
            faces[i] = tri[:3]
        return verts, faces
    # ascii fallback
    lines = data[end:].decode().split("\n")
    verts = np.array([[float(x) for x in lines[i].split()[:3]]
                      for i in range(nv)], np.float32)
    faces = np.array([[int(x) for x in lines[nv + i].split()[1:4]]
                      for i in range(nf)], np.uint32)
    return verts, faces
