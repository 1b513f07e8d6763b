"""Offline visualization and map export (port of
``dvo_slam_tpu.utils.visualization``): headless, file-producing
equivalents of the original's visualizers — matplotlib trajectory, graph
and error-image figures, PLY point clouds and per-edge error images.

The figures need matplotlib, imported on first use (Agg backend, no
display): without it they raise ``ImportError`` naming it.  The PLY
export needs only NumPy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    return plt


def plot_trajectory(
    path: str,
    est_poses: np.ndarray,
    gt_poses: Optional[np.ndarray] = None,
    title: str = "trajectory",
):
    """Top-down (x-z) trajectory plot, estimated vs optional ground truth."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 6))
    est = np.asarray(est_poses)
    ax.plot(est[:, 0, 3], est[:, 2, 3], "-", label="estimated", linewidth=1.5)
    if gt_poses is not None:
        gt = np.asarray(gt_poses)
        ax.plot(gt[:, 0, 3], gt[:, 2, 3], "--", label="ground truth", linewidth=1.0)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_title(title)
    ax.axis("equal")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_pose_graph(path: str, keyframe_graph, title: str = "pose graph"):
    """Keyframe positions + edges, loop closures colored by Cauchy weight
    (the reference GraphVisualizer's chi2-colored markers,
    graph_visualizer.cpp:157-170)."""
    plt = _plt()
    g = keyframe_graph.graph
    w, chi2 = keyframe_graph.edge_errors()
    fig, ax = plt.subplots(figsize=(6, 6))
    positions = {}
    for key in g.vertex_keys():
        positions[g.vertex_index(key)] = g.vertex_pose(key)[:3, 3]
    for k in range(g.num_edges):
        if not g.edge_active[k]:
            continue
        a = positions[int(g.edge_i[k])]
        b = positions[int(g.edge_j[k])]
        if g.robust[k]:
            color = (1.0 - float(w[k]), float(w[k]), 0.1)
            lw = 1.6
        else:
            color, lw = (0.3, 0.3, 0.8), 0.7
        ax.plot([a[0], b[0]], [a[2], b[2]], "-", color=color, linewidth=lw)
    kf = np.asarray([k.pose[:3, 3] for k in keyframe_graph.keyframes])
    if len(kf):
        ax.plot(kf[:, 0], kf[:, 2], "ko", markersize=3, label="keyframes")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_title(title)
    ax.axis("equal")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def export_point_cloud_ply(
    path: str,
    intensity: np.ndarray,
    depth: np.ndarray,
    valid: np.ndarray,
    intrinsics,
    pose: Optional[np.ndarray] = None,
    stride: int = 2,
):
    """Write one RGB-D frame as an ASCII PLY point cloud in world
    coordinates (the AsyncPointCloudBuilder/PointCloudAggregator analog,
    dvo_core/src/visualization/*)."""
    h, w = depth.shape
    v_idx, u_idx = np.mgrid[0:h:stride, 0:w:stride]
    z = depth[::stride, ::stride]
    ok = valid[::stride, ::stride] & (z > 0)
    x = (u_idx - intrinsics.ox) / intrinsics.fx * z
    y = (v_idx - intrinsics.oy) / intrinsics.fy * z
    pts = np.stack([x[ok], y[ok], z[ok]], axis=-1)
    if pose is not None:
        pts = pts @ np.asarray(pose)[:3, :3].T + np.asarray(pose)[:3, 3]
    gray = np.clip(intensity[::stride, ::stride][ok], 0, 255).astype(np.uint8)
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(pts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        for p, g in zip(pts, gray):
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {g} {g} {g}\n")


def export_edge_error_images(
    out_dir: str,
    keyframe_graph,
    intrinsics,
    worst_k: int = 5,
    level: int = 0,
):
    """Per-edge intensity-error-image drill-down for the worst loop
    closures — the headless form of the reference GraphVisualizer's
    context-menu inspection (graph_visualizer.cpp:46-68: clicking a
    chi2-colored edge renders its intensity error image).

    Ranks active robustified edges by chi2, warps one keyframe into the
    other with the edge's measurement, and writes
    ``edge_<i>_<j>_chi2_<value>.png`` heatmaps.  Returns the written paths.
    """
    import os

    import torch

    from ..ops.warp import intensity_error_image

    g = keyframe_graph.graph
    w, chi2 = keyframe_graph.edge_errors()
    by_id = {k.id: k for k in keyframe_graph.keyframes}
    idx_of = {g.vertex_index(("kf", kid)): kid for kid in by_id}
    candidates = []
    for k in range(g.num_edges):
        if not (g.edge_active[k] and g.robust[k]):
            continue
        i, j = int(g.edge_i[k]), int(g.edge_j[k])
        if i in idx_of and j in idx_of:
            candidates.append((float(chi2[k]), k, idx_of[i], idx_of[j]))
    candidates.sort(reverse=True)
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for c2, k, ki, kj in candidates[:worst_k]:
        kf_i, kf_j = by_id[ki], by_id[kj]
        if kf_i.frame.levels is None or kf_j.frame.levels is None:
            continue
        lv_i = kf_i.frame.levels[level]
        lv_j = kf_j.frame.levels[level]
        # the edge stores the pose of j in frame i; the inverse is the
        # warp transform the error image needs (see warp_intensity_inverse)
        T = torch.as_tensor(np.linalg.inv(g.measurements[k]).astype(np.float32),
                            device=lv_i.intensity.device)
        err, ok = intensity_error_image(
            lv_i, lv_j, intrinsics.at_level(level), T
        )
        path = os.path.join(out_dir, f"edge_{ki}_{kj}_chi2_{c2:.3f}.png")
        save_error_image(path, err.cpu().numpy(), ok.cpu().numpy())
        written.append(path)
    return written


def save_error_image(path: str, error: np.ndarray, valid: np.ndarray):
    """Save an intensity-error heatmap (computeIntensityErrorImage output)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4.5))
    shown = np.where(valid, error, np.nan)
    im = ax.imshow(shown, cmap="magma")
    fig.colorbar(im, ax=ax, label="|I_cur(w(x)) - I_ref(x)|")
    ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
