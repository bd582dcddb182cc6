"""Interactive scene inspection: one self-contained WebGL HTML file.

The port's own copy of `rfdnet_tpu/utils/scene_html.py` (numpy only; the
same payload and template, so both packages write identical bytes from
the same inputs). The file embeds the geometry as base64 (raw WebGL1, no
external assets or network fetches) and opens offline in any browser with
orbit / pan / zoom, per-layer toggles (points / meshes / boxes / arrows),
class or instance colors and a class legend.

It shares `SceneRender`'s data model (`scene_viz.py`): scene points,
per-instance (verts, faces) meshes, boxes as a center and 3 half-edge
vectors, per-instance class ids. A comparison export packs two scenes
(pred / gt) behind a radio switch.

The file is written in pieces: the base64 buffers (most of its bytes: a
MISE scene's meshes make it ~1 GB) go straight to the file between the
JSON around them, which is what the JAX package's `json.dumps` of the
whole payload gives (base64 needs no escaping), written as UTF-8.
"""

from __future__ import annotations

import base64
import json
import os

import numpy as np

from .scene_viz import _BOX_FACES, _corners, hls_palette

__all__ = ["export_scene_html", "export_comparison_html"]

# Box wireframe edges over the 8 corners produced by `_corners`
# (ring order: bottom 0-1-2-3, top 4-5-6-7, corner k+4 above corner k).
_BOX_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def _b64(arr: np.ndarray) -> bytes:
    """The base64 text of the array's bytes (ASCII), kept as bytes until
    `_export` writes it."""
    return base64.b64encode(np.ascontiguousarray(arr).tobytes())


def _viridis_r(t: np.ndarray) -> np.ndarray:
    """Small built-in viridis_r ramp (avoids importing matplotlib for the
    export path); matches scene_viz._depth_colors' palette choice — the
    crest_r analogue of `vis_gt.py:37`."""
    # 9 anchor colors of viridis, reversed
    anchors = np.array(
        [
            [0.993, 0.906, 0.144],
            [0.741, 0.873, 0.150],
            [0.468, 0.819, 0.316],
            [0.246, 0.744, 0.504],
            [0.128, 0.648, 0.564],
            [0.164, 0.545, 0.558],
            [0.229, 0.439, 0.548],
            [0.312, 0.312, 0.542],
            [0.267, 0.005, 0.329],
        ],
        np.float64,
    )
    t = np.clip(np.asarray(t, np.float64), 0.0, 1.0) * (len(anchors) - 1)
    i0 = np.minimum(t.astype(np.int64), len(anchors) - 2)
    f = (t - i0)[:, None]
    return anchors[i0] * (1 - f) + anchors[i0 + 1] * f


def _flat_shade_mesh(verts: np.ndarray, faces: np.ndarray):
    """Expand an indexed mesh to per-face-duplicated vertices with flat
    normals (WebGL1 has no flat interpolation qualifier)."""
    v = np.asarray(verts, np.float32)
    f = np.asarray(faces, np.int64)
    tri = v[f.reshape(-1)].reshape(-1, 3, 3)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.maximum(norm, 1e-12)
    pos = tri.reshape(-1, 3)
    nrm = np.repeat(n, 3, axis=0).astype(np.float32)
    return pos, nrm


def _pack_scene(render, color_mode: str, max_points: int) -> dict:
    """Pack one SceneRender into base64 buffer dict for the HTML payload."""
    pts = np.asarray(render.scene_points, np.float64)
    step = max(1, len(pts) // max_points)
    sub = pts[::step].astype(np.float32)
    centroid = sub.mean(axis=0) if len(sub) else np.zeros(3)
    d = np.linalg.norm(sub - centroid, axis=1)
    lo, hi = (d.min(), d.max()) if len(d) else (0.0, 1.0)
    t = (d - lo) / (hi - lo) if hi > lo else np.zeros_like(d)
    pcol = (_viridis_r(t) * 255).astype(np.uint8)

    # meshes: one concatenated flat-shaded VBO, per-vertex class/inst color
    mpos, mnrm, mcol = [], [], []
    for i, (v, f) in enumerate(render.meshes):
        if len(v) == 0 or len(f) == 0:
            continue
        p, n = _flat_shade_mesh(v, f)
        c = (
            render._cls_color(i)
            if color_mode == "class"
            else render._inst_color(i)
        )
        mpos.append(p)
        mnrm.append(n)
        mcol.append(
            np.tile((np.asarray(c) * 255).astype(np.uint8), (len(p), 1))
        )
    mp = np.vstack(mpos) if mpos else np.zeros((0, 3), np.float32)
    mn = np.vstack(mnrm) if mnrm else np.zeros((0, 3), np.float32)
    mc = np.vstack(mcol) if mcol else np.zeros((0, 3), np.uint8)

    # boxes: wireframe line segments + translucent face triangles
    lpos, lcol, fpos, fcol, apos, acol = [], [], [], [], [], []
    axis_rgb = np.eye(3) * 255
    for i, (c, vec) in enumerate(zip(render.centers, render.vectors)):
        col = (
            render._cls_color(i)
            if color_mode == "class"
            else render._inst_color(i)
        )
        col8 = (np.asarray(col) * 255).astype(np.uint8)
        corners = _corners(np.asarray(c, np.float64),
                           np.asarray(vec, np.float64)).astype(np.float32)
        for a, b in _BOX_EDGES:
            lpos.extend([corners[a], corners[b]])
            lcol.extend([col8, col8])
        for face in _BOX_FACES:
            q = corners[list(face)]
            for tri in ((0, 1, 2), (0, 2, 3)):
                fpos.extend(q[list(tri)])
                fcol.extend([col8] * 3)
        # RGB axis arrows (`vis_gt.py:198-203`): line + small head segs
        for k in range(3):
            dvec = np.asarray(vec[k], np.float64)
            nn = np.linalg.norm(dvec)
            if nn < 1e-9:
                continue
            dvec = dvec / nn * 0.5
            tip = np.asarray(c) + dvec
            apos.extend([np.asarray(c, np.float32), tip.astype(np.float32)])
            ac = axis_rgb[k].astype(np.uint8)
            acol.extend([ac, ac])
            # arrow head: two short back-swept segments in a plane ⊥ dvec
            ortho = np.cross(dvec, [0.0, 0.0, 1.0])
            if np.linalg.norm(ortho) < 1e-9:
                ortho = np.cross(dvec, [0.0, 1.0, 0.0])
            ortho = ortho / np.linalg.norm(ortho) * 0.08
            back = tip - dvec * 0.25
            for s in (1.0, -1.0):
                apos.extend(
                    [tip.astype(np.float32), (back + s * ortho).astype(
                        np.float32)]
                )
                acol.extend([ac, ac])

    def seg(x, dt):
        return (
            np.asarray(x, dt)
            if len(x)
            else np.zeros((0, 3), dt)
        )

    return {
        "points": {"pos": _b64(sub), "col": _b64(pcol), "n": len(sub)},
        "mesh": {"pos": _b64(mp), "nrm": _b64(mn), "col": _b64(mc),
                 "n": len(mp)},
        "box_lines": {"pos": _b64(seg(lpos, np.float32)),
                      "col": _b64(seg(lcol, np.uint8)),
                      "n": len(lpos)},
        "box_faces": {"pos": _b64(seg(fpos, np.float32)),
                      "col": _b64(seg(fcol, np.uint8)),
                      "n": len(fpos)},
        "arrows": {"pos": _b64(seg(apos, np.float32)),
                   "col": _b64(seg(acol, np.uint8)),
                   "n": len(apos)},
    }


def _bounds(renders) -> dict:
    los, his = [], []
    for r in renders:
        p = np.asarray(r.scene_points, np.float64)
        if len(p):
            los.append(p.min(axis=0))
            his.append(p.max(axis=0))
        for v, _ in r.meshes:
            if len(v):
                los.append(np.asarray(v, np.float64).min(axis=0))
                his.append(np.asarray(v, np.float64).max(axis=0))
    if not los:
        return {"center": [0, 0, 0], "radius": 1.0}
    lo = np.min(los, axis=0)
    hi = np.max(his, axis=0)
    mid = (lo + hi) / 2
    return {
        "center": mid.tolist(),
        "radius": float(max(np.linalg.norm(hi - mid), 1e-6)),
    }


def export_scene_html(render, path: str, title: str = "scene",
                      class_names=(), color_mode: str = "class",
                      max_points: int = 120000) -> str:
    """Export one scene as an interactive HTML file (the `vis_gt.py` /
    `vis_prediction.py` windows)."""
    return _export(
        {"scene": _pack_scene(render, color_mode, max_points)},
        _bounds([render]), path, title, class_names,
        hls_palette(len(render.palette_cls)),
    )


def export_comparison_html(pred, gt, path: str,
                           title: str = "pred vs gt", class_names=(),
                           color_mode: str = "class",
                           max_points: int = 120000) -> str:
    """Pred-vs-GT switcher in one window (`vis_for_comparison.py`'s two
    renders)."""
    return _export(
        {
            "pred": _pack_scene(pred, color_mode, max_points),
            "gt": _pack_scene(gt, color_mode, max_points),
        },
        _bounds([pred, gt]), path, title, class_names,
        hls_palette(len(pred.palette_cls)),
    )


def _export(scenes, bounds, path, title, class_names, palette) -> str:
    legend = [
        {"name": str(n), "color": [int(x * 255) for x in palette[i % len(
            palette)]]}
        for i, n in enumerate(class_names)
    ]
    buffers = []

    def placeholders(node):
        # each base64 buffer -> a token that JSON leaves as it is
        if isinstance(node, dict):
            return {k: placeholders(v) for k, v in node.items()}
        if isinstance(node, bytes):
            buffers.append(node)
            return f"__B64_{len(buffers) - 1}__"
        return node

    payload = json.dumps(
        {"scenes": placeholders(scenes), "bounds": bounds, "legend": legend,
         "title": title},
        separators=(",", ":"),
    )
    pieces = []
    for i, text in enumerate(payload.split('"__B64_')):
        if i:
            n, text = text.split('__"', 1)
            pieces.append(b'"' + buffers[int(n)] + b'"')
        pieces.append(text.encode("utf-8"))
    page = _TEMPLATE.replace("__TITLE__", title).split("__PAYLOAD__")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as fh:
        for j, part in enumerate(page):
            if j:
                for piece in pieces:
                    fh.write(piece)
            fh.write(part.encode("utf-8"))
    return path


_TEMPLATE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title><style>
html,body{margin:0;height:100%;overflow:hidden;background:#181a1f;
font:13px system-ui,sans-serif;color:#ddd}
#c{width:100%;height:100%;display:block;cursor:grab}
#panel{position:absolute;top:10px;left:10px;background:rgba(24,26,31,.85);
border:1px solid #333;border-radius:6px;padding:10px 12px;max-width:230px}
#panel h1{font-size:14px;margin:0 0 6px}
label{display:block;margin:2px 0;user-select:none}
.sw{display:inline-block;width:12px;height:12px;border-radius:2px;
margin-right:6px;vertical-align:-1px}
#legend{margin-top:8px;border-top:1px solid #333;padding-top:6px}
#help{position:absolute;bottom:8px;left:12px;color:#888;font-size:11px}
</style></head><body>
<canvas id="c"></canvas>
<div id="panel"><h1>__TITLE__</h1><div id="scenesw"></div>
<label><input type="checkbox" id="tpts" checked> points</label>
<label><input type="checkbox" id="tmesh" checked> meshes</label>
<label><input type="checkbox" id="tbox" checked> boxes</label>
<label><input type="checkbox" id="tarr" checked> orientation arrows</label>
<div id="legend"></div></div>
<div id="help">drag: orbit &nbsp; shift/right-drag: pan &nbsp;
wheel: zoom &nbsp; a: axes</div>
<script>
"use strict";
const DATA = __PAYLOAD__;
function b64f32(s){const b=atob(s);const a=new Uint8Array(b.length);
 for(let i=0;i<b.length;i++)a[i]=b.charCodeAt(i);
 return new Float32Array(a.buffer);}
function b64u8(s){const b=atob(s);const a=new Uint8Array(b.length);
 for(let i=0;i<b.length;i++)a[i]=b.charCodeAt(i);return a;}
const cv=document.getElementById("c");
const gl=cv.getContext("webgl",{antialias:true,alpha:false});
function sh(type,src){const s=gl.createShader(type);gl.shaderSource(s,src);
 gl.compileShader(s);
 if(!gl.getShaderParameter(s,gl.COMPILE_STATUS))
   throw new Error(gl.getShaderInfoLog(s));return s;}
function prog(vs,fs){const p=gl.createProgram();
 gl.attachShader(p,sh(gl.VERTEX_SHADER,vs));
 gl.attachShader(p,sh(gl.FRAGMENT_SHADER,fs));gl.linkProgram(p);
 if(!gl.getProgramParameter(p,gl.LINK_STATUS))
   throw new Error(gl.getProgramInfoLog(p));return p;}
const VS_PT=`attribute vec3 p;attribute vec3 c;uniform mat4 mvp;
uniform float ps;varying vec3 vc;
void main(){gl_Position=mvp*vec4(p,1.);gl_PointSize=ps;vc=c;}`;
const FS_PT=`precision mediump float;varying vec3 vc;uniform float op;
void main(){gl_FragColor=vec4(vc,op);}`;
const VS_ME=`attribute vec3 p;attribute vec3 n;attribute vec3 c;
uniform mat4 mvp;varying vec3 vc;varying vec3 vp;varying vec3 vn;
void main(){gl_Position=mvp*vec4(p,1.);vc=c;vp=p;vn=n;}`;
const FS_ME=`precision mediump float;varying vec3 vc;varying vec3 vp;
varying vec3 vn;uniform vec3 eye;uniform float op;
void main(){vec3 l=normalize(eye-vp);
 float d=abs(dot(normalize(vn),l));
 gl_FragColor=vec4(vc*(0.35+0.65*d),op);}`;
const P_PT=prog(VS_PT,FS_PT),P_ME=prog(VS_ME,FS_ME);
function mkbuf(data){const b=gl.createBuffer();
 gl.bindBuffer(gl.ARRAY_BUFFER,b);
 gl.bufferData(gl.ARRAY_BUFFER,data,gl.STATIC_DRAW);return b;}
function layer(d,hasN){if(!d||d.n===0)return null;
 const l={n:d.n,pos:mkbuf(b64f32(d.pos)),col:mkbuf(b64u8(d.col))};
 if(hasN)l.nrm=mkbuf(b64f32(d.nrm));return l;}
const scenes={};
for(const k in DATA.scenes){const s=DATA.scenes[k];
 scenes[k]={points:layer(s.points,false),mesh:layer(s.mesh,true),
  box_lines:layer(s.box_lines,false),box_faces:layer(s.box_faces,false),
  arrows:layer(s.arrows,false)};}
let active=Object.keys(scenes)[0];
// scene switcher (pred/gt)
const swdiv=document.getElementById("scenesw");
if(Object.keys(scenes).length>1){
 for(const k of Object.keys(scenes)){
  const lab=document.createElement("label");
  const r=document.createElement("input");r.type="radio";r.name="sc";
  r.checked=(k===active);r.onchange=()=>{active=k;draw();};
  lab.appendChild(r);lab.appendChild(document.createTextNode(" "+k));
  swdiv.appendChild(lab);}}
// legend
const lg=document.getElementById("legend");
for(const e of DATA.legend){const d=document.createElement("div");
 const s=document.createElement("span");s.className="sw";
 s.style.background=`rgb(${e.color[0]},${e.color[1]},${e.color[2]})`;
 d.appendChild(s);d.appendChild(document.createTextNode(e.name));
 lg.appendChild(d);}
// camera: z-up orbit around bounds center (VTK interactor equivalent)
const B=DATA.bounds;let tgt=B.center.slice(),dist=B.radius*2.2;
let az=-1.05,el=0.62,showAxes=false;
function m4mul(a,b){const o=new Float32Array(16);
 for(let i=0;i<4;i++)for(let j=0;j<4;j++){let s=0;
  for(let k=0;k<4;k++)s+=a[k*4+j]*b[i*4+k];o[i*4+j]=s;}return o;}
function persp(fov,asp,near,far){const f=1/Math.tan(fov/2);
 return new Float32Array([f/asp,0,0,0, 0,f,0,0,
  0,0,(far+near)/(near-far),-1, 0,0,2*far*near/(near-far),0]);}
function lookat(e,t,up){
 const z=[e[0]-t[0],e[1]-t[1],e[2]-t[2]];
 let n=Math.hypot(z[0],z[1],z[2]);z[0]/=n;z[1]/=n;z[2]/=n;
 const x=[up[1]*z[2]-up[2]*z[1],up[2]*z[0]-up[0]*z[2],
  up[0]*z[1]-up[1]*z[0]];
 n=Math.hypot(x[0],x[1],x[2]);x[0]/=n;x[1]/=n;x[2]/=n;
 const y=[z[1]*x[2]-z[2]*x[1],z[2]*x[0]-z[0]*x[2],z[0]*x[1]-z[1]*x[0]];
 return new Float32Array([x[0],y[0],z[0],0, x[1],y[1],z[1],0,
  x[2],y[2],z[2],0,
  -(x[0]*e[0]+x[1]*e[1]+x[2]*e[2]),
  -(y[0]*e[0]+y[1]*e[1]+y[2]*e[2]),
  -(z[0]*e[0]+z[1]*e[1]+z[2]*e[2]),1]);}
function eyePos(){const ce=Math.cos(el);
 return [tgt[0]+dist*ce*Math.cos(az),tgt[1]+dist*ce*Math.sin(az),
  tgt[2]+dist*Math.sin(el)];}
let axbuf=null;
function axesLayer(){if(axbuf)return axbuf;const r=B.radius*0.5;
 const c=B.center;
 const pos=new Float32Array([c[0],c[1],c[2],c[0]+r,c[1],c[2],
  c[0],c[1],c[2],c[0],c[1]+r,c[2], c[0],c[1],c[2],c[0],c[1],c[2]+r]);
 const col=new Uint8Array([255,60,60,255,60,60, 60,255,60,60,255,60,
  80,80,255,80,80,255]);
 axbuf={n:6,pos:mkbuf(pos),col:mkbuf(col)};return axbuf;}
function bind(p,l,hasN){
 const ap=gl.getAttribLocation(p,"p");
 gl.bindBuffer(gl.ARRAY_BUFFER,l.pos);
 gl.enableVertexAttribArray(ap);
 gl.vertexAttribPointer(ap,3,gl.FLOAT,false,0,0);
 const ac=gl.getAttribLocation(p,"c");
 gl.bindBuffer(gl.ARRAY_BUFFER,l.col);
 gl.enableVertexAttribArray(ac);
 gl.vertexAttribPointer(ac,3,gl.UNSIGNED_BYTE,true,0,0);
 if(hasN){const an=gl.getAttribLocation(p,"n");
  gl.bindBuffer(gl.ARRAY_BUFFER,l.nrm);
  gl.enableVertexAttribArray(an);
  gl.vertexAttribPointer(an,3,gl.FLOAT,false,0,0);}}
function draw(){
 const w=cv.clientWidth,h=cv.clientHeight;
 if(cv.width!==w||cv.height!==h){cv.width=w;cv.height=h;}
 gl.viewport(0,0,w,h);
 gl.clearColor(0.094,0.102,0.122,1);
 gl.enable(gl.DEPTH_TEST);
 gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 const eye=eyePos();
 const mvp=m4mul(persp(0.9,w/h,B.radius*0.01,B.radius*40),
  lookat(eye,tgt,[0,0,1]));
 const S=scenes[active];
 const vis={points:document.getElementById("tpts").checked,
  mesh:document.getElementById("tmesh").checked,
  box:document.getElementById("tbox").checked,
  arr:document.getElementById("tarr").checked};
 if(vis.mesh&&S.mesh){gl.useProgram(P_ME);
  gl.uniformMatrix4fv(gl.getUniformLocation(P_ME,"mvp"),false,mvp);
  gl.uniform3fv(gl.getUniformLocation(P_ME,"eye"),eye);
  gl.uniform1f(gl.getUniformLocation(P_ME,"op"),1.0);
  bind(P_ME,S.mesh,true);gl.drawArrays(gl.TRIANGLES,0,S.mesh.n);}
 gl.useProgram(P_PT);
 gl.uniformMatrix4fv(gl.getUniformLocation(P_PT,"mvp"),false,mvp);
 const uop=gl.getUniformLocation(P_PT,"op"),
  ups=gl.getUniformLocation(P_PT,"ps");
 if(vis.points&&S.points){gl.uniform1f(uop,0.85);gl.uniform1f(ups,2.0);
  bind(P_PT,S.points,false);gl.drawArrays(gl.POINTS,0,S.points.n);}
 if(vis.box&&S.box_lines){gl.uniform1f(uop,1.0);
  bind(P_PT,S.box_lines,false);gl.drawArrays(gl.LINES,0,S.box_lines.n);}
 if(vis.arr&&S.arrows){gl.uniform1f(uop,1.0);
  bind(P_PT,S.arrows,false);gl.drawArrays(gl.LINES,0,S.arrows.n);}
 if(showAxes){gl.uniform1f(uop,1.0);const A=axesLayer();
  bind(P_PT,A,false);gl.drawArrays(gl.LINES,0,A.n);}
 if(vis.box&&S.box_faces){ // translucent faces last (SetOpacity(0.2))
  gl.enable(gl.BLEND);gl.blendFunc(gl.SRC_ALPHA,gl.ONE_MINUS_SRC_ALPHA);
  gl.depthMask(false);gl.uniform1f(uop,0.12);
  bind(P_PT,S.box_faces,false);
  gl.drawArrays(gl.TRIANGLES,0,S.box_faces.n);
  gl.depthMask(true);gl.disable(gl.BLEND);}
}
let drag=null;
cv.addEventListener("mousedown",e=>{drag={x:e.clientX,y:e.clientY,
 pan:e.shiftKey||e.button===2};cv.style.cursor="grabbing";});
window.addEventListener("mouseup",()=>{drag=null;
 cv.style.cursor="grab";});
window.addEventListener("mousemove",e=>{if(!drag)return;
 const dx=e.clientX-drag.x,dy=e.clientY-drag.y;
 drag.x=e.clientX;drag.y=e.clientY;
 if(drag.pan){const s=dist*0.0012,ca=Math.cos(az),sa=Math.sin(az);
  tgt[0]+=(-dx*-sa+dy*Math.sin(el)*ca)*s;
  tgt[1]+=(-dx*ca+dy*Math.sin(el)*sa)*s;
  tgt[2]+=dy*Math.cos(el)*s;}
 else{az-=dx*0.008;el=Math.min(1.55,Math.max(-1.55,el+dy*0.008));}
 draw();});
cv.addEventListener("wheel",e=>{e.preventDefault();
 dist*=Math.exp(e.deltaY*0.0012);draw();},{passive:false});
cv.addEventListener("contextmenu",e=>e.preventDefault());
window.addEventListener("keydown",e=>{
 if(e.key==="a"){showAxes=!showAxes;draw();}});
for(const id of["tpts","tmesh","tbox","tarr"])
 document.getElementById(id).onchange=draw;
window.addEventListener("resize",draw);
draw();
</script></body></html>
"""
