"""Standalone 3D map viewer: self-contained HTML (Three.js) with the
decimated point cloud, trajectory, keyframes, and loop-closure markers.

The headless replacement for the reference's RViz profiles
(`fast_lio_sam/config/*_rviz.rviz`, SURVEY.md §1 L5): open the file in any
browser — orbit controls, height- or intensity-colored points, loop edges
drawn like `getLoopMarkers` (`fast_lio_sam.cpp:1060-1091`).

The port's own numpy copy of ``fastliosam_tpu/postprocess/viewer3d.py``.
"""
from __future__ import annotations

import base64
import json

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>body{{margin:0;background:#0c0f14;color:#ccc;font:12px sans-serif}}
#info{{position:absolute;top:8px;left:10px;z-index:2}}</style></head>
<body><div id="info">{title} — {n_pts} pts, {n_kf} keyframes, {n_loops} loops.
Drag = orbit, wheel = zoom, right-drag = pan.</div>
<script type="importmap">{{"imports":{{
 "three":"https://unpkg.com/three@0.160.0/build/three.module.js",
 "three/addons/":"https://unpkg.com/three@0.160.0/examples/jsm/"}}}}</script>
<script type="module">
import * as THREE from 'three';
import {{OrbitControls}} from 'three/addons/controls/OrbitControls.js';
const B64="{b64}";
const raw=Uint8Array.from(atob(B64),c=>c.charCodeAt(0));
const f=new Float32Array(raw.buffer);
const n={n_pts};
const pos=f.subarray(0,n*3);
const scene=new THREE.Scene();
const cam=new THREE.PerspectiveCamera(60,innerWidth/innerHeight,0.1,5000);
const renderer=new THREE.WebGLRenderer({{antialias:true}});
renderer.setSize(innerWidth,innerHeight);document.body.appendChild(renderer.domElement);
const geo=new THREE.BufferGeometry();
geo.setAttribute('position',new THREE.BufferAttribute(pos,3));
let zmin=1e9,zmax=-1e9;
for(let i=0;i<n;i++){{const z=pos[i*3+2];if(z<zmin)zmin=z;if(z>zmax)zmax=z;}}
const col=new Float32Array(n*3);
for(let i=0;i<n;i++){{
  const t=(pos[i*3+2]-zmin)/Math.max(zmax-zmin,1e-6);
  const c=new THREE.Color().setHSL(0.66*(1-t),0.85,0.35+0.35*t);
  col[i*3]=c.r;col[i*3+1]=c.g;col[i*3+2]=c.b;}}
geo.setAttribute('color',new THREE.BufferAttribute(col,3));
scene.add(new THREE.Points(geo,new THREE.PointsMaterial({{size:0.07,vertexColors:true}})));
const traj={traj};
if(traj.length>1){{
  const tg=new THREE.BufferGeometry().setFromPoints(traj.map(p=>new THREE.Vector3(...p)));
  scene.add(new THREE.Line(tg,new THREE.LineBasicMaterial({{color:0x00ff88}})));}}
const loops={loops};
for(const [a,b] of loops){{
  const lg=new THREE.BufferGeometry().setFromPoints(
    [new THREE.Vector3(...traj[a]),new THREE.Vector3(...traj[b])]);
  scene.add(new THREE.Line(lg,new THREE.LineBasicMaterial({{color:0xffcc00}})));}}
scene.add(new THREE.AxesHelper(5));
const ctr=traj.length?traj[Math.floor(traj.length/2)]:[0,0,0];
cam.position.set(ctr[0]+30,ctr[1]-30,ctr[2]+30);cam.up.set(0,0,1);
const controls=new OrbitControls(cam,renderer.domElement);
controls.target.set(...ctr);controls.update();
addEventListener('resize',()=>{{cam.aspect=innerWidth/innerHeight;
cam.updateProjectionMatrix();renderer.setSize(innerWidth,innerHeight);}});
(function anim(){{requestAnimationFrame(anim);controls.update();
renderer.render(scene,cam);}})();
</script></body></html>
"""


def write_map_viewer(
    out_path: str,
    points: np.ndarray,  # (N, 3)
    trajectory: np.ndarray | None = None,  # (K, 3)
    loop_pairs: list | None = None,  # [(i, j)] keyframe indices
    max_points: int = 300_000,
    title: str = "fastliosam_tpu map",
) -> str:
    """Write the self-contained viewer HTML. Returns the path."""
    pts = np.asarray(points, np.float32)
    if len(pts) > max_points:
        sel = np.random.default_rng(0).choice(len(pts), max_points, replace=False)
        pts = pts[sel]
    traj = (
        np.asarray(trajectory, np.float32).tolist()
        if trajectory is not None
        else []
    )
    loops = [list(map(int, p)) for p in (loop_pairs or [])]
    b64 = base64.b64encode(pts.tobytes()).decode()
    html = _PAGE.format(
        title=title,
        n_pts=len(pts),
        n_kf=len(traj),
        n_loops=len(loops),
        b64=b64,
        traj=json.dumps(traj),
        loops=json.dumps(loops),
    )
    with open(out_path, "w") as f:
        f.write(html)
    return out_path
