"""Offline visualization: PLY clouds, trajectory plots, tracked-point overlays.

Replaces the reference's Pangolin/OpenGL viewer stack (Drawer/Viewer.cpp,
Drawer/MapDrawer.cpp, Drawer/OctomapDrawer.cpp rendering) with export-based
visualization suited to headless GPU hosts: point clouds and occupancy voxels
go to PLY (any viewer opens them), trajectories to PNG via matplotlib, and the
tracked-feature overlay (Frame::drawTackedPoints, Core/Frame.cpp:400-413) to
an image array.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def save_ply(path: str, xyz: np.ndarray, intensity: Optional[np.ndarray] = None,
             valid: Optional[np.ndarray] = None) -> int:
    """Write a point cloud (optionally gray-colored) as binary-less ASCII PLY."""
    xyz = np.asarray(xyz).reshape(-1, 3)
    if valid is not None:
        mask = np.asarray(valid).reshape(-1)
        xyz = xyz[mask]
        if intensity is not None:
            intensity = np.asarray(intensity).reshape(-1)[mask]
    n = len(xyz)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if intensity is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        if intensity is not None:
            g = np.clip(np.asarray(intensity), 0, 255).astype(np.uint8)
            for p, c in zip(xyz, g):
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {c} {c} {c}\n")
        else:
            for p in xyz:
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")
    return n


def plot_trajectories(path: str, trajectories: Sequence, labels: Sequence[str],
                      title: str = "trajectory (top-down)") -> None:
    """Top-down (x-z) trajectory comparison plot -> PNG. Each trajectory is
    an (N, 4, 4) array of Twc poses."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 6))
    for poses, label in zip(trajectories, labels):
        p = np.asarray(poses)[:, :3, 3]
        ax.plot(p[:, 0], p[:, 2], label=label, linewidth=1.2)
        ax.scatter([p[0, 0]], [p[0, 2]], marker="o", s=25)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend()
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_trajectory_quick(path: str, poses: np.ndarray,
                          size: int = 480) -> None:
    """Top-down (x-z) trajectory -> PNG via direct numpy rasterization —
    ~15x faster than the matplotlib figure (no GIL-heavy render), used by
    the LIVE exporter where the write shares the interpreter with the
    tracking thread. `poses` is (N, 4, 4) Twc."""
    from matplotlib.image import imsave

    p = np.asarray(poses)[:, :3, 3]
    canvas = np.full((size, size, 3), 255, np.uint8)
    if len(p) >= 2:
        x, z = p[:, 0], p[:, 2]
        lo = np.array([x.min(), z.min()])
        span = max(float(x.max() - lo[0]), float(z.max() - lo[1]), 1e-6)
        m = 20
        sx = ((x - lo[0]) / span * (size - 2 * m) + m)
        # image rows grow downward; flip z so +z points up
        sz = (size - 1 - ((z - lo[1]) / span * (size - 2 * m) + m))
        for i in range(len(p) - 1):
            steps = int(max(abs(sx[i + 1] - sx[i]),
                            abs(sz[i + 1] - sz[i]), 1)) + 1
            xs = np.linspace(sx[i], sx[i + 1], steps).astype(int)
            ys = np.linspace(sz[i], sz[i + 1], steps).astype(int)
            ok = (ys >= 0) & (ys < size) & (xs >= 0) & (xs < size)
            canvas[ys[ok], xs[ok]] = (30, 90, 200)
        x0, y0 = int(sx[0]), int(sz[0])
        canvas[max(y0 - 3, 0):y0 + 4, max(x0 - 3, 0):x0 + 4] = (0, 170, 0)
    imsave(path, canvas)


def draw_matches(gray1: np.ndarray, uv1: np.ndarray, gray2: np.ndarray,
                 uv2: np.ndarray, idx2: np.ndarray, valid: np.ndarray,
                 max_lines: int = 200) -> np.ndarray:
    """Side-by-side match visualization (Matcher::drawMatches,
    Features/Matcher.cpp:19-33): frames stacked horizontally, matched
    keypoints connected."""
    h = max(gray1.shape[0], gray2.shape[0])
    w1, w2 = gray1.shape[1], gray2.shape[1]
    canvas = np.zeros((h, w1 + w2, 3), np.uint8)
    for img, off in ((gray1, 0), (gray2, w1)):
        g = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
        canvas[: g.shape[0], off : off + g.shape[1]] = g[..., None]

    n_drawn = 0
    for i in np.nonzero(np.asarray(valid))[0]:
        if n_drawn >= max_lines:
            break
        x1, y1 = int(round(uv1[i, 0])), int(round(uv1[i, 1]))
        j = int(idx2[i])
        x2, y2 = int(round(uv2[j, 0])) + w1, int(round(uv2[j, 1]))
        # simple Bresenham-free line: sample along the segment
        steps = max(abs(x2 - x1), abs(y2 - y1), 1)
        xs = np.linspace(x1, x2, steps).astype(int)
        ys = np.linspace(y1, y2, steps).astype(int)
        ok = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w1 + w2)
        canvas[ys[ok], xs[ok]] = (0, 220, 0)
        n_drawn += 1
    return canvas


def draw_tracked_points(gray: np.ndarray, uv: np.ndarray, inlier: np.ndarray,
                        valid: np.ndarray) -> np.ndarray:
    """RGB overlay of tracked keypoints: inliers bright, others dim
    (Frame::drawTackedPoints semantics, Core/Frame.cpp:400-413)."""
    g = np.clip(np.asarray(gray), 0, 255).astype(np.uint8)
    img = np.stack([g, g, g], axis=-1)
    h, w = g.shape
    for (u, v), inl, ok in zip(np.asarray(uv), np.asarray(inlier), np.asarray(valid)):
        if not ok:
            continue
        x, y = int(round(u)), int(round(v))
        if not (1 <= x < w - 1 and 1 <= y < h - 1):
            continue
        color = (0, 255, 0) if inl else (128, 128, 128)
        img[y - 1 : y + 2, x - 1 : x + 2] = color
    return img


def save_html_viewer(path: str, xyz: np.ndarray,
                     intensity: Optional[np.ndarray] = None,
                     poses_twc: Optional[np.ndarray] = None,
                     max_points: int = 200_000) -> None:
    """Self-contained interactive 3-D map viewer (single HTML file).

    The reference's Viewer/MapDrawer is a live Pangolin GL window
    (Drawer/Viewer.cpp:39-136: landmarks, camera frusta, trajectory); on a
    headless host the equivalent artifact is an offline viewer — a
    zero-dependency HTML canvas renderer with drag-rotate / wheel-zoom that
    embeds the landmark cloud and keyframe trajectory as JSON.
    """
    import json as _json

    xyz = np.asarray(xyz, dtype=np.float32)
    if len(xyz) > max_points:
        step = int(np.ceil(len(xyz) / max_points))
        xyz = xyz[::step]
        intensity = intensity[::step] if intensity is not None else None
    inten = (np.clip(np.asarray(intensity), 0, 255).astype(int).tolist()
             if intensity is not None else [200] * len(xyz))
    pts = np.round(xyz, 4).tolist()
    traj = []
    if poses_twc is not None:
        traj = np.round(np.asarray(poses_twc)[:, :3, 3], 4).tolist()

    html = """<!doctype html><meta charset="utf-8">
<title>rgbdslam map</title>
<style>body{margin:0;background:#111;color:#ccc;font:12px monospace}
#hud{position:fixed;top:8px;left:8px}</style>
<canvas id=c></canvas><div id=hud></div>
<script>
const PTS=__PTS__,INT=__INT__,TRAJ=__TRAJ__;
const cv=document.getElementById('c'),ctx=cv.getContext('2d');
let W,H;function rs(){W=cv.width=innerWidth;H=cv.height=innerHeight;draw()}
onresize=rs;
let yaw=0.5,pitch=0.4,dist=8,cx=0,cy=0,cz=0;
if(PTS.length){let n=PTS.length,sx=0,sy=0,sz=0;
for(const p of PTS){sx+=p[0];sy+=p[1];sz+=p[2]}cx=sx/n;cy=sy/n;cz=sz/n}
function draw(){ctx.fillStyle='#111';ctx.fillRect(0,0,W,H);
const cyaw=Math.cos(yaw),syaw=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
const f=0.9*Math.min(W,H);
function proj(p){let x=p[0]-cx,y=p[1]-cy,z=p[2]-cz;
let x1=cyaw*x+syaw*z,z1=-syaw*x+cyaw*z;
let y2=cp*y-sp*z1,z2=sp*y+cp*z1+dist;
if(z2<0.1)return null;return[W/2+f*x1/z2,H/2+f*y2/z2]}
for(let i=0;i<PTS.length;i++){const q=proj(PTS[i]);if(!q)continue;
const g=INT[i];ctx.fillStyle=`rgb(${g},${g},${g})`;
ctx.fillRect(q[0],q[1],2,2)}
if(TRAJ.length){ctx.strokeStyle='#e33';ctx.lineWidth=2;ctx.beginPath();
let started=false;
for(const t of TRAJ){const q=proj(t);if(!q)continue;
if(!started){ctx.moveTo(q[0],q[1]);started=true}else ctx.lineTo(q[0],q[1])}
ctx.stroke()}
document.getElementById('hud').textContent=
  `${PTS.length} pts  ${TRAJ.length} keyframes  drag=rotate wheel=zoom`}
let drag=false,lx=0,ly=0;
cv.onmousedown=e=>{drag=true;lx=e.clientX;ly=e.clientY};
onmouseup=()=>drag=false;
onmousemove=e=>{if(!drag)return;yaw+=(e.clientX-lx)*0.01;
pitch+=(e.clientY-ly)*0.01;lx=e.clientX;ly=e.clientY;draw()};
onwheel=e=>{dist*=e.deltaY>0?1.1:0.9;draw()};
rs();
</script>"""
    html = (html.replace("__PTS__", _json.dumps(pts))
                .replace("__INT__", _json.dumps(inten))
                .replace("__TRAJ__", _json.dumps(traj)))
    with open(path, "w") as f:
        f.write(html)
