"""Interactive (client-side) pose-graph viewer — single-file HTML export
(port of ``dvo_slam_tpu.utils.interactive_viz``; the HTML template is the
original's, unchanged).

The reference ships two *interactive* visualizers that the headless
matplotlib exports in ``utils/visualization.py`` only partially replace:

* ``dvo_slam`` GraphVisualizer (graph_visualizer.cpp:70-429): RViz
  interactive markers for keyframes and edges, loop closures colored by
  chi2/robust weight, and a context menu that renders an edge's intensity
  error image or deletes the edge.
* ``dvo_ros`` RosCameraTrajectoryVisualizer
  (ros_camera_trajectory_visualizer.cpp): camera frusta, per-keyframe
  point clouds, and trajectory lines in a rotatable 3-D view.

This module produces the batch-pipeline equivalent: ONE
self-contained HTML file (no network, no external JS — most batch
clusters have zero egress) with an embedded pure-JS canvas
renderer providing

* drag-rotate / wheel-zoom / shift-drag-pan 3-D view,
* trajectory line, keyframe frusta, downsampled per-keyframe point
  clouds (toggleable),
* odometry edges and chi2/robust-weight-colored loop-closure edges,
* click-an-edge inspection: chi2, robust weight, level, endpoint ids,
  plus the edge's intensity error image rendered on a canvas (the
  context-menu drill-down), and a client-side "delete edge" toggle.

Everything is computed at export time on the host; the HTML is inert
data + viewer and can be archived next to trajectory dumps.
"""

from __future__ import annotations

import json
import os

import numpy as np


def _host(t) -> np.ndarray:
    """A tensor (on any device) or an array as a NumPy array."""
    if hasattr(t, "detach"):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _downsample_cloud(level, pose, intrinsics, stride: int, max_points: int):
    """One pyramid level -> world-frame [M,3] points + [M] gray values."""
    inten = _host(level.intensity)
    depth = _host(level.depth)
    valid = _host(level.valid)
    h, w = depth.shape
    v_idx, u_idx = np.mgrid[0:h:stride, 0:w:stride]
    z = depth[::stride, ::stride]
    ok = valid[::stride, ::stride] & (z > 0)
    x = (u_idx - intrinsics.ox) / intrinsics.fx * z
    y = (v_idx - intrinsics.oy) / intrinsics.fy * z
    pts = np.stack([x[ok], y[ok], z[ok]], axis=-1)
    gray = np.clip(inten[::stride, ::stride][ok], 0, 255)
    if len(pts) > max_points:
        sel = np.linspace(0, len(pts) - 1, max_points).astype(int)
        pts, gray = pts[sel], gray[sel]
    pose = np.asarray(pose)
    pts = pts @ pose[:3, :3].T + pose[:3, 3]
    return pts.astype(np.float32), gray.astype(np.uint8)


def _edge_error_payload(keyframe_graph, intrinsics, worst_k: int, level: int,
                        max_width: int = 160):
    """Worst-k robust edges -> error images as small uint8 grids.

    The heatmap itself is drawn client-side (magma-ish colormap in JS), so
    the payload is raw normalized error values, not PNG bytes.
    """
    import torch

    from ..ops.warp import intensity_error_image

    g = keyframe_graph.graph
    w, chi2 = keyframe_graph.edge_errors()
    by_id = {k.id: k for k in keyframe_graph.keyframes}
    idx_of = {g.vertex_index(("kf", kid)): kid for kid in by_id}
    ranked = []
    for k in range(g.num_edges):
        if not (g.edge_active[k] and g.robust[k]):
            continue
        i, j = int(g.edge_i[k]), int(g.edge_j[k])
        if i in idx_of and j in idx_of:
            ranked.append((float(chi2[k]), k, idx_of[i], idx_of[j]))
    ranked.sort(reverse=True)
    out = {}
    for c2, k, ki, kj in ranked[:worst_k]:
        kf_i, kf_j = by_id[ki], by_id[kj]
        if kf_i.frame.levels is None or kf_j.frame.levels is None:
            continue
        lv_i, lv_j = kf_i.frame.levels[level], kf_j.frame.levels[level]
        if lv_i is None or lv_j is None:
            continue
        T = torch.as_tensor(np.linalg.inv(g.measurements[k]).astype(np.float32),
                            device=lv_i.intensity.device)
        err, ok = intensity_error_image(lv_i, lv_j, intrinsics.at_level(level), T)
        err, ok = _host(err), _host(ok)
        step = max(1, err.shape[1] // max_width)
        err, ok = err[::step, ::step], ok[::step, ::step]
        scale = float(err[ok].max()) if ok.any() else 1.0
        grid = np.where(ok, np.clip(err / max(scale, 1e-6) * 255, 0, 255), 0)
        out[k] = {
            "h": int(grid.shape[0]),
            "w": int(grid.shape[1]),
            "max": scale,
            "data": grid.astype(np.uint8).ravel().tolist(),
        }
    return out


def export_interactive_graph(
    path: str,
    keyframe_graph,
    intrinsics=None,
    title: str = "dvo_slam_tpu pose graph",
    cloud_level: int = 2,
    cloud_stride: int = 2,
    max_cloud_points: int = 3000,
    error_images: bool = True,
    error_worst_k: int = 5,
    error_level: int = 0,
    live_refresh_seconds: float = 0.0,
) -> str:
    """Write the self-contained interactive HTML viewer. Returns ``path``.

    ``intrinsics`` enables point clouds and error-image drill-down; without
    it the viewer shows trajectory, frusta, and edges only.
    ``live_refresh_seconds > 0`` adds a meta-refresh so a browser pointed
    at the file follows a running SLAM session (see ``attach_live_viewer``).
    """
    g = keyframe_graph.graph
    w, chi2 = keyframe_graph.edge_errors()

    positions = {}
    for key in g.vertex_keys():
        positions[g.vertex_index(key)] = g.vertex_pose(key)[:3, 3]

    stamps, traj_poses = keyframe_graph.trajectory()
    trajectory = [list(map(float, p[:3, 3])) for p in traj_poses]

    keyframes = []
    for kf in keyframe_graph.keyframes:
        keyframes.append({
            "id": int(kf.id),
            "t": float(kf.timestamp),
            "pose": np.asarray(kf.pose, np.float64).ravel().tolist(),
        })

    kf_index = {g.vertex_index(("kf", kf.id)): int(kf.id)
                for kf in keyframe_graph.keyframes}
    edges = []
    for k in range(g.num_edges):
        i, j = int(g.edge_i[k]), int(g.edge_j[k])
        if i not in positions or j not in positions:
            continue
        edges.append({
            "k": k,
            "a": list(map(float, positions[i])),
            "b": list(map(float, positions[j])),
            "i": kf_index.get(i, -1),
            "j": kf_index.get(j, -1),
            "robust": bool(g.robust[k]),
            "active": bool(g.edge_active[k]),
            "level": int(np.asarray(g.edge_level)[k]) if hasattr(g, "edge_level") else 0,
            "w": float(w[k]),
            "chi2": float(chi2[k]),
        })

    clouds = []
    if intrinsics is not None:
        lv_intr = intrinsics.at_level(cloud_level)
        for kf in keyframe_graph.keyframes:
            if kf.frame.levels is None or len(kf.frame.levels) <= cloud_level:
                continue
            lv = kf.frame.levels[cloud_level]
            if lv is None:
                continue
            pts, gray = _downsample_cloud(
                lv, kf.pose, lv_intr, cloud_stride, max_cloud_points)
            clouds.append({
                "id": int(kf.id),
                "pts": np.round(pts, 4).ravel().tolist(),
                "gray": gray.tolist(),
            })

    errimgs = {}
    if error_images and intrinsics is not None:
        errimgs = _edge_error_payload(
            keyframe_graph, intrinsics, error_worst_k, error_level)

    payload = {
        "title": title,
        "trajectory": trajectory,
        "keyframes": keyframes,
        "edges": edges,
        "clouds": clouds,
        "errimgs": {str(k): v for k, v in errimgs.items()},
    }
    html = _HTML_TEMPLATE.replace("__DATA__", json.dumps(payload))
    html = html.replace("__TITLE__", title)
    if live_refresh_seconds > 0:
        html = html.replace(
            "<meta charset=\"utf-8\">",
            "<meta charset=\"utf-8\">"
            f"<meta http-equiv=\"refresh\" content=\"{live_refresh_seconds:g}\">",
        )
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(html)
    os.replace(tmp, path)  # atomic: a live-refreshing browser never sees a torn file
    return path


def attach_live_viewer(keyframe_graph, path: str, intrinsics=None,
                       refresh_seconds: float = 2.0, **export_kw):
    """Re-export the interactive viewer on every map change — the live
    analog of the reference's RViz visualizers subscribing to the
    map-changed signal (keyframe_graph.cpp:497 → GraphVisualizer /
    RosCameraTrajectoryVisualizer; intermediate-trajectory dumps
    keyframe_tracker.cpp:203-214).

    Returns the callback so callers can invoke it manually (e.g. once
    after ``finish()``); it is also registered on the graph.
    """
    def _on_map_changed(*_args):
        export_interactive_graph(
            path, keyframe_graph, intrinsics=intrinsics,
            live_refresh_seconds=refresh_seconds, **export_kw)

    keyframe_graph.add_map_changed_callback(_on_map_changed)
    return _on_map_changed


# Pure-JS canvas viewer. Kept dependency-free on purpose: the file must
# open from disk on an air-gapped machine (file://, zero egress).
_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body{margin:0;display:flex;font:13px sans-serif;background:#111;color:#ddd}
 #view{flex:1;height:100vh;display:block;cursor:grab}
 #panel{width:300px;padding:10px;overflow-y:auto;background:#1a1a1a;border-left:1px solid #333}
 .hint{color:#888;font-size:11px}
 button{margin:2px 0;background:#333;color:#ddd;border:1px solid #555;padding:3px 8px;cursor:pointer}
 label{display:block;margin:3px 0}
 #edgeinfo{margin-top:8px;padding:6px;background:#222;border:1px solid #444;display:none}
 canvas.err{width:100%;image-rendering:pixelated;border:1px solid #444;margin-top:4px}
 h3{margin:4px 0}
</style></head><body>
<canvas id="view"></canvas>
<div id="panel">
 <h3>__TITLE__</h3>
 <div class="hint">drag: rotate &middot; wheel: zoom &middot; shift-drag: pan<br>
 click an edge to inspect it (the GraphVisualizer context menu)</div>
 <label><input type="checkbox" id="showClouds" checked> point clouds</label>
 <label><input type="checkbox" id="showFrusta" checked> keyframe frusta</label>
 <label><input type="checkbox" id="showOdom" checked> odometry edges</label>
 <label><input type="checkbox" id="showLoops" checked> loop closures (chi&sup2;-colored)</label>
 <div id="stats"></div>
 <div id="edgeinfo"></div>
</div>
<script>
const D = __DATA__;
const cv = document.getElementById('view'), ctx = cv.getContext('2d');
let yaw = 0.6, pitch = 0.4, zoom = 1, panX = 0, panY = 0, sel = null;
const deleted = new Set();
// scene center + scale from trajectory (fallback: keyframe positions)
let pts = D.trajectory.length ? D.trajectory : D.keyframes.map(k=>[k.pose[3],k.pose[7],k.pose[11]]);
if (!pts.length) pts = [[0,0,0]];
const C = [0,1,2].map(a => pts.reduce((s,p)=>s+p[a],0)/pts.length);
let R = Math.max(...pts.map(p=>Math.hypot(p[0]-C[0],p[1]-C[1],p[2]-C[2])), 0.1);
function proj(p){
  const x=p[0]-C[0], y=p[1]-C[1], z=p[2]-C[2];
  const cy=Math.cos(yaw), sy=Math.sin(yaw), cp=Math.cos(pitch), sp=Math.sin(pitch);
  const x1 = cy*x + sy*z, z1 = -sy*x + cy*z;
  const y1 = cp*y - sp*z1, z2 = sp*y + cp*z1;
  const s = Math.min(cv.width, cv.height)*0.42/R*zoom;
  return [cv.width/2 + x1*s + panX, cv.height/2 + y1*s + panY, z2];
}
function magma(v){ // v in 0..255 -> rough magma ramp
  const t=v/255;
  return `rgb(${Math.round(255*Math.min(1,2.1*t))},${Math.round(255*Math.max(0,t*t*1.2-0.05))},${Math.round(255*Math.min(1,0.5+Math.sin(3.14*t)*0.5*(1-t)+t*0.3))})`;
}
function frustumLines(pose, s){
  const o=[pose[3],pose[7],pose[11]];
  const ax=i=>[pose[0+i],pose[4+i],pose[8+i]];
  const X=ax(0),Y=ax(1),Z=ax(2);
  const corner=(u,v)=>[0,1,2].map(a=>o[a]+s*(u*X[a]+v*Y[a]+1.6*Z[a]));
  const c=[corner(-1,-0.75),corner(1,-0.75),corner(1,0.75),corner(-1,0.75)];
  const L=[];
  for(let i=0;i<4;i++){L.push([o,c[i]]);L.push([c[i],c[(i+1)%4]]);}
  return L;
}
let edgeHits = [];
function draw(){
  cv.width = cv.clientWidth; cv.height = cv.clientHeight;
  ctx.fillStyle='#111'; ctx.fillRect(0,0,cv.width,cv.height);
  edgeHits = [];
  if (document.getElementById('showClouds').checked){
    for (const c of D.clouds){
      for (let i=0;i<c.gray.length;i++){
        const p = proj([c.pts[3*i],c.pts[3*i+1],c.pts[3*i+2]]);
        const g = c.gray[i];
        ctx.fillStyle = `rgb(${g},${g},${g})`;
        ctx.fillRect(p[0],p[1],1.5,1.5);
      }
    }
  }
  // trajectory
  ctx.strokeStyle='#4af'; ctx.lineWidth=1.4; ctx.beginPath();
  D.trajectory.forEach((p,i)=>{const q=proj(p); i?ctx.lineTo(q[0],q[1]):ctx.moveTo(q[0],q[1]);});
  ctx.stroke();
  // edges
  const showO=document.getElementById('showOdom').checked;
  const showL=document.getElementById('showLoops').checked;
  for (const e of D.edges){
    if (!e.active || deleted.has(e.k)) continue;
    if (e.robust ? !showL : !showO) continue;
    const a=proj(e.a), b=proj(e.b);
    if (e.robust){
      ctx.strokeStyle=`rgb(${Math.round(255*(1-e.w))},${Math.round(255*e.w)},40)`;
      ctx.lineWidth = (sel===e.k)?3.2:1.8;
    } else {
      ctx.strokeStyle=(sel===e.k)?'#bbf':'#557'; ctx.lineWidth=(sel===e.k)?2.4:0.8;
    }
    ctx.beginPath(); ctx.moveTo(a[0],a[1]); ctx.lineTo(b[0],b[1]); ctx.stroke();
    edgeHits.push([(a[0]+b[0])/2,(a[1]+b[1])/2,e]);
  }
  // keyframes
  if (document.getElementById('showFrusta').checked){
    ctx.strokeStyle='#fa4'; ctx.lineWidth=0.9;
    for (const k of D.keyframes){
      for (const [p,q] of frustumLines(k.pose, R*0.04)){
        const a=proj(p), b=proj(q);
        ctx.beginPath(); ctx.moveTo(a[0],a[1]); ctx.lineTo(b[0],b[1]); ctx.stroke();
      }
    }
  }
  const nL = D.edges.filter(e=>e.robust&&e.active&&!deleted.has(e.k)).length;
  document.getElementById('stats').innerHTML =
    `<p>${D.keyframes.length} keyframes &middot; ${D.edges.length} edges `+
    `(${nL} active loop closures) &middot; ${D.trajectory.length} poses</p>`;
}
function showEdge(e){
  sel = e.k;
  const el = document.getElementById('edgeinfo');
  el.style.display='block';
  el.innerHTML = `<b>edge ${e.i} &rarr; ${e.j}</b> (${e.robust?'loop closure':'odometry'})<br>
    chi&sup2; = ${e.chi2.toExponential(3)}<br>robust weight = ${e.w.toFixed(4)}<br>
    level = ${e.level}<br>
    <button id="delbtn">${deleted.has(e.k)?'restore edge':'delete edge'}</button>`;
  const img = D.errimgs[String(e.k)];
  if (img){
    const c = document.createElement('canvas');
    c.className='err'; c.width=img.w; c.height=img.h;
    const g = c.getContext('2d'), im = g.createImageData(img.w, img.h);
    for (let i=0;i<img.data.length;i++){
      const col = magma(img.data[i]).match(/\\d+/g).map(Number);
      im.data[4*i]=col[0]; im.data[4*i+1]=col[1]; im.data[4*i+2]=col[2]; im.data[4*i+3]=255;
    }
    g.putImageData(im,0,0);
    el.appendChild(document.createTextNode(`intensity error image (max ${img.max.toFixed(1)})`));
    el.appendChild(c);
  }
  document.getElementById('delbtn').onclick = ()=>{
    deleted.has(e.k) ? deleted.delete(e.k) : deleted.add(e.k);
    showEdge(e); draw();
  };
  draw();
}
let drag=null;
cv.onmousedown = ev => drag=[ev.clientX,ev.clientY,ev.shiftKey,false];
window.onmousemove = ev => {
  if (!drag) return;
  const dx=ev.clientX-drag[0], dy=ev.clientY-drag[1];
  if (Math.abs(dx)+Math.abs(dy)>2) drag[3]=true;
  if (drag[2]){panX+=dx; panY+=dy;} else {yaw+=dx*0.008; pitch+=dy*0.008;}
  drag[0]=ev.clientX; drag[1]=ev.clientY; draw();
};
window.onmouseup = ev => {
  if (drag && !drag[3]){ // click: pick nearest edge midpoint
    const r = cv.getBoundingClientRect();
    const mx=ev.clientX-r.left, my=ev.clientY-r.top;
    let best=null, bd=14*14;
    for (const [x,y,e] of edgeHits){
      const d=(x-mx)*(x-mx)+(y-my)*(y-my);
      if (d<bd){bd=d;best=e;}
    }
    if (best) showEdge(best);
  }
  drag=null;
};
cv.onwheel = ev => {zoom*=Math.exp(-ev.deltaY*0.001); ev.preventDefault(); draw();};
for (const id of ['showClouds','showFrusta','showOdom','showLoops'])
  document.getElementById(id).onchange=draw;
window.onresize = draw;
draw();
</script></body></html>
"""
