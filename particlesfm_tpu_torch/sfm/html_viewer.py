"""Self-contained interactive reconstruction viewer (single HTML file).

The reference's `visualize.py` opens an interactive Open3D window
(upstream visualize.py:15-67) — impossible headless. This writes one
dependency-free HTML file (vanilla WebGL, data embedded as base64) with the
same content: colored sparse points + red camera frusta, orbit/zoom/pan.
Open it in any browser; nothing is fetched over the network. A copy of
particlesfm_tpu/sfm/html_viewer.py.
"""
from __future__ import annotations

import base64
import json
from pathlib import Path

import numpy as np
import torch

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>particlesfm_tpu reconstruction</title>
<style>
 html,body{margin:0;height:100%;overflow:hidden;background:#111;color:#ddd;
   font:12px monospace}
 #hud{position:fixed;left:8px;top:8px;pointer-events:none;white-space:pre}
 canvas{display:block;width:100vw;height:100vh}
</style></head><body>
<div id="hud"></div><canvas id="c"></canvas>
<script>
"use strict";
const META = __META__;
function b64f32(s){const b=atob(s),a=new Uint8Array(b.length);
  for(let i=0;i<b.length;i++)a[i]=b.charCodeAt(i);return a.buffer;}
const pos = new Float32Array(b64f32("__POS_B64__"));
const colU8raw = atob("__COL_B64__");
const col = new Uint8Array(colU8raw.length);
for(let i=0;i<col.length;i++)col[i]=colU8raw.charCodeAt(i);
const cam = new Float32Array(b64f32("__CAM_B64__"));   // frustum line segments
const N = pos.length/3, NC = cam.length/6;

const canvas=document.getElementById("c");
const gl=canvas.getContext("webgl",{antialias:true});
const VS=`attribute vec3 p;attribute vec3 c;uniform mat4 mvp;
uniform float ps;varying vec3 vc;
void main(){gl_Position=mvp*vec4(p,1.0);gl_PointSize=ps;vc=c;}`;
const FS=`precision mediump float;varying vec3 vc;
void main(){gl_FragColor=vec4(vc,1.0);}`;
function sh(t,s){const o=gl.createShader(t);gl.shaderSource(o,s);
  gl.compileShader(o);return o;}
const prog=gl.createProgram();
gl.attachShader(prog,sh(gl.VERTEX_SHADER,VS));
gl.attachShader(prog,sh(gl.FRAGMENT_SHADER,FS));
gl.linkProgram(prog);gl.useProgram(prog);
const aP=gl.getAttribLocation(prog,"p"),aC=gl.getAttribLocation(prog,"c");
const uMVP=gl.getUniformLocation(prog,"mvp"),uPS=gl.getUniformLocation(prog,"ps");

const bPos=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,bPos);
gl.bufferData(gl.ARRAY_BUFFER,pos,gl.STATIC_DRAW);
const cf=new Float32Array(col.length);
for(let i=0;i<col.length;i++)cf[i]=col[i]/255;
const bCol=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,bCol);
gl.bufferData(gl.ARRAY_BUFFER,cf,gl.STATIC_DRAW);
const bCam=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,bCam);
gl.bufferData(gl.ARRAY_BUFFER,cam,gl.STATIC_DRAW);
const camColor=new Float32Array(cam.length);
for(let i=0;i<camColor.length;i+=3){camColor[i]=1;camColor[i+1]=.15;camColor[i+2]=.15;}
const bCamC=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,bCamC);
gl.bufferData(gl.ARRAY_BUFFER,camColor,gl.STATIC_DRAW);

// --- camera state: orbit around scene centroid ---------------------------
let cx=META.center,rad=META.radius*2.2,yaw=0.6,pitch=0.4,panX=0,panY=0,ps=2;
function mat(){
  const aspect=canvas.width/canvas.height,f=1/Math.tan(0.4);
  const near=META.radius*0.002,far=META.radius*40;
  const cp=Math.cos(pitch),sp=Math.sin(pitch),cy=Math.cos(yaw),sy=Math.sin(yaw);
  const eye=[cx[0]+rad*cp*sy,cx[1]+rad*sp,cx[2]+rad*cp*cy];
  const tgt=[cx[0],cx[1],cx[2]];
  let zx=eye[0]-tgt[0],zy=eye[1]-tgt[1],zz=eye[2]-tgt[2];
  const zl=Math.hypot(zx,zy,zz);zx/=zl;zy/=zl;zz/=zl;
  let xx=zz,xy=0,xz=-zx;const xl=Math.hypot(xx,xy,xz)||1;xx/=xl;xz/=xl;
  const yx=zy*xz-zz*xy,yy=zz*xx-zx*xz,yz=zx*xy-zy*xx;
  const px=panX*rad,py=panY*rad;
  const ex=eye[0]+xx*px+yx*py,ey=eye[1]+xy*px+yy*py,ez=eye[2]+xz*px+yz*py;
  const tx=-(xx*ex+xy*ey+xz*ez),ty=-(yx*ex+yy*ey+yz*ez),tz=-(zx*ex+zy*ey+zz*ez);
  const nf=1/(near-far);
  // column-major proj*view
  const v=[xx,yx,zx,0, xy,yy,zy,0, xz,yz,zz,0, tx,ty,tz,1];
  const p=[f/aspect,0,0,0, 0,f,0,0, 0,0,(near+far)*nf,-1, 0,0,2*near*far*nf,0];
  const m=new Float32Array(16);
  for(let i=0;i<4;i++)for(let j=0;j<4;j++){let s=0;
    for(let k=0;k<4;k++)s+=p[k*4+j]*v[i*4+k];m[i*4+j]=s;}
  return m;
}
function draw(){
  canvas.width=innerWidth*devicePixelRatio;canvas.height=innerHeight*devicePixelRatio;
  gl.viewport(0,0,canvas.width,canvas.height);
  gl.enable(gl.DEPTH_TEST);gl.clearColor(0.07,0.07,0.08,1);
  gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
  gl.uniformMatrix4fv(uMVP,false,mat());gl.uniform1f(uPS,ps*devicePixelRatio);
  gl.enableVertexAttribArray(aP);gl.enableVertexAttribArray(aC);
  gl.bindBuffer(gl.ARRAY_BUFFER,bPos);gl.vertexAttribPointer(aP,3,gl.FLOAT,false,0,0);
  gl.bindBuffer(gl.ARRAY_BUFFER,bCol);gl.vertexAttribPointer(aC,3,gl.FLOAT,false,0,0);
  gl.drawArrays(gl.POINTS,0,N);
  gl.bindBuffer(gl.ARRAY_BUFFER,bCam);gl.vertexAttribPointer(aP,3,gl.FLOAT,false,0,0);
  gl.bindBuffer(gl.ARRAY_BUFFER,bCamC);gl.vertexAttribPointer(aC,3,gl.FLOAT,false,0,0);
  gl.drawArrays(gl.LINES,0,NC*2);
  document.getElementById("hud").textContent=
    `${META.name}\\n${N} points  ${META.num_cameras} cameras\\n`+
    `drag orbit · shift-drag/right-drag pan · wheel zoom · +/- point size`;
}
let dragging=false,panning=false,lx=0,ly=0;
canvas.addEventListener("mousedown",e=>{dragging=true;
  panning=e.button===2||e.shiftKey;lx=e.clientX;ly=e.clientY;});
addEventListener("mouseup",()=>dragging=false);
canvas.addEventListener("contextmenu",e=>e.preventDefault());
addEventListener("mousemove",e=>{if(!dragging)return;
  const dx=(e.clientX-lx)/innerWidth,dy=(e.clientY-ly)/innerHeight;
  if(panning){panX-=dx*1.5;panY+=dy*1.5;}
  else{yaw-=dx*4;pitch=Math.max(-1.5,Math.min(1.5,pitch+dy*4));}
  lx=e.clientX;ly=e.clientY;requestAnimationFrame(draw);});
canvas.addEventListener("wheel",e=>{e.preventDefault();
  rad*=Math.exp(e.deltaY*0.001);requestAnimationFrame(draw);},{passive:false});
addEventListener("keydown",e=>{if(e.key==="+"||e.key==="=")ps=Math.min(ps+1,12);
  if(e.key==="-")ps=Math.max(ps-1,1);requestAnimationFrame(draw);});
addEventListener("resize",()=>requestAnimationFrame(draw));
draw();
</script></body></html>
"""


def _b64(arr: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode()


def write_html_viewer(out_path, xyz: np.ndarray, rgb: np.ndarray,
                      frusta_segments: np.ndarray, name: str = "reconstruction",
                      max_points: int = 400_000) -> None:
    """Write the viewer. xyz [N,3] f32, rgb [N,3] u8, frusta_segments [M,2,3]
    f32 world-space line segments (camera wireframes)."""
    xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
    rgb = np.asarray(rgb, np.uint8).reshape(-1, 3)
    if xyz.shape[0] > max_points:
        step = int(np.ceil(xyz.shape[0] / max_points))
        xyz, rgb = xyz[::step], rgb[::step]
    segs = np.asarray(frusta_segments, np.float32).reshape(-1, 2, 3)
    all_pts = xyz if xyz.size else segs.reshape(-1, 3)
    center = (all_pts.mean(axis=0) if all_pts.size else np.zeros(3)).tolist()
    radius = float(np.linalg.norm(all_pts - center, axis=1).max()) if all_pts.size else 1.0
    meta = {"name": name, "center": center, "radius": max(radius, 1e-6),
            "num_cameras": int(segs.shape[0] // 8) if segs.size else 0}
    html = (_TEMPLATE
            .replace("__META__", json.dumps(meta))
            .replace("__POS_B64__", _b64(xyz))
            .replace("__COL_B64__", _b64(rgb))
            .replace("__CAM_B64__", _b64(segs)))
    Path(out_path).write_text(html)


def frusta_from_images(images, quat_to_rotmat, scale: float) -> np.ndarray:
    """Build [M,2,3] wireframe segments (8 per camera: 4 apex->corner +
    4 corner ring) from COLMAP-convention images."""
    corners = np.array([[-1, -0.6, 1.5], [1, -0.6, 1.5],
                        [1, 0.6, 1.5], [-1, 0.6, 1.5]]) * scale
    segs = []
    for im in images.values():
        R = quat_to_rotmat(torch.as_tensor(im.qvec, dtype=torch.float32)).numpy()
        c = -R.T @ np.asarray(im.tvec)
        world = (R.T @ corners.T).T + c
        for k in range(4):
            segs.append([c, world[k]])
            segs.append([world[k], world[(k + 1) % 4]])
    return (np.asarray(segs, np.float32) if segs
            else np.zeros((0, 2, 3), np.float32))
