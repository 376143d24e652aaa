"""Visualization helpers (reference utils/visualizers/color_util.py spirit):
colormaps for depth/error maps without matplotlib, HTML embedding and an
offline WebGL viewer.

The port's copy of open_diffusiongs_tpu/utils/visualizers.py (:26-202),
NumPy only; the port imports nothing of the JAX package."""

from __future__ import annotations

import numpy as np

# compact viridis-ish control points (t, r, g, b)
_VIRIDIS = np.asarray([
    [0.0, 0.267, 0.005, 0.329],
    [0.25, 0.229, 0.322, 0.546],
    [0.5, 0.128, 0.567, 0.551],
    [0.75, 0.369, 0.789, 0.383],
    [1.0, 0.993, 0.906, 0.144],
])

_TURBO = np.asarray([
    [0.0, 0.190, 0.072, 0.232],
    [0.25, 0.275, 0.408, 0.882],
    [0.5, 0.150, 0.900, 0.500],
    [0.75, 0.970, 0.730, 0.180],
    [1.0, 0.480, 0.016, 0.011],
])


def _apply(points: np.ndarray, t: np.ndarray) -> np.ndarray:
    t = np.clip(t, 0.0, 1.0)
    out = np.empty(t.shape + (3,), np.float32)
    for c in range(3):
        out[..., c] = np.interp(t, points[:, 0], points[:, c + 1])
    return out


def colormap(values: np.ndarray, vmin=None, vmax=None,
             cmap: str = "viridis") -> np.ndarray:
    """[...]-shaped scalars -> [..., 3] float colors in [0, 1]."""
    vmin = float(values.min()) if vmin is None else vmin
    vmax = float(values.max()) if vmax is None else vmax
    t = (values - vmin) / max(vmax - vmin, 1e-12)
    return _apply(_VIRIDIS if cmap == "viridis" else _TURBO, t)


def depth_to_rgb(depth: np.ndarray, near=None, far=None) -> np.ndarray:
    """Depth map [h, w] -> uint8 [h, w, 3] turbo visualization."""
    rgb = colormap(depth, near, far, cmap="turbo")
    return (rgb * 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# HTML embedding (reference utils/visualizers/html_util.py)
# ---------------------------------------------------------------------------

def to_image_embed_tag(image: np.ndarray) -> str:
    """uint8/float [h, w, 3] image -> <img> tag with a base64 PNG data URI
    (html_util.py:35-43)."""
    import base64
    import io

    from PIL import Image

    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    b64 = base64.b64encode(buf.getvalue()).decode("ascii")
    return f'<img src="data:image/png;base64,{b64}"/>'


def to_single_row_table(caption: str, content: str) -> str:
    """One-cell captioned table (html_util.py:21-32)."""
    return (f"<table><caption>{caption}</caption>"
            f"<tr><td>{content}</td></tr></table>")


def to_html_frame(content: str) -> str:
    """Wrap body content in a minimal standalone page (html_util.py:8-18)."""
    return (f"<html><head><meta charset=\"utf-8\"/></head>"
            f"<body>{content}</body></html>")


def save_html(path: str, body: str) -> str:
    import os
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(to_html_frame(body))
    return path


# ---------------------------------------------------------------------------
# Offline 3D viewer (reference utils/visualizers/pythreejs_viewer.py
# capability: debug-view meshes / point clouds without a GPU stack).
# Generates ONE self-contained HTML file: data embedded as JSON, rendering
# via raw WebGL (no CDN / no external JS — the image has zero egress).
# ---------------------------------------------------------------------------

_VIEWER_JS = """
const cv=document.getElementById('c');const gl=cv.getContext('webgl');
const VS=`attribute vec3 p;attribute vec3 n;attribute vec3 col;
uniform mat4 mvp;uniform mat4 mv;varying vec3 vn;varying vec3 vc;
void main(){gl_Position=mvp*vec4(p,1.);gl_PointSize=3.;
vn=mat3(mv)*n;vc=col;}`;
const FS=`precision mediump float;varying vec3 vn;varying vec3 vc;
void main(){float l=.35+.65*max(dot(normalize(vn),vec3(0.,0.,1.)),0.);
gl_FragColor=vec4(vc*l,1.);}`;
function sh(t,s){const o=gl.createShader(t);gl.shaderSource(o,s);
gl.compileShader(o);return o;}
const pr=gl.createProgram();gl.attachShader(pr,sh(gl.VERTEX_SHADER,VS));
gl.attachShader(pr,sh(gl.FRAGMENT_SHADER,FS));gl.linkProgram(pr);
gl.useProgram(pr);gl.enable(gl.DEPTH_TEST);
function buf(a,d,n){const b=gl.createBuffer();
gl.bindBuffer(gl.ARRAY_BUFFER,b);
gl.bufferData(gl.ARRAY_BUFFER,new Float32Array(d),gl.STATIC_DRAW);
const l=gl.getAttribLocation(pr,a);gl.enableVertexAttribArray(l);
gl.vertexAttribPointer(l,n,gl.FLOAT,false,0,0);return b;}
// center + scale
let mn=[1e9,1e9,1e9],mx=[-1e9,-1e9,-1e9];
for(let i=0;i<P.length;i+=3)for(let k=0;k<3;k++){
mn[k]=Math.min(mn[k],P[i+k]);mx[k]=Math.max(mx[k],P[i+k]);}
const ctr=[0,1,2].map(k=>(mn[k]+mx[k])/2);
const sc=2.0/Math.max(mx[0]-mn[0],mx[1]-mn[1],mx[2]-mn[2],1e-9);
for(let i=0;i<P.length;i+=3)for(let k=0;k<3;k++)P[i+k]=(P[i+k]-ctr[k])*sc;
let rx=-0.5,ry=0.6,dist=3.2,drag=false,px=0,py=0;
cv.onmousedown=e=>{drag=true;px=e.clientX;py=e.clientY;};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{if(!drag)return;
ry+=(e.clientX-px)*.01;rx+=(e.clientY-py)*.01;px=e.clientX;py=e.clientY;
draw();};
cv.onwheel=e=>{e.preventDefault();dist*=Math.exp(e.deltaY*.001);draw();};
function mat(){const cx=Math.cos(rx),sx=Math.sin(rx),
cy=Math.cos(ry),sy=Math.sin(ry);
const R=[cy,sx*sy,-cx*sy,0, 0,cx,sx,0, sy,-sx*cy,cx*cy,0, 0,0,-dist,1];
const f=2.4,a=cv.width/cv.height,zn=.01,zf=100.;
const Pm=[f/a,0,0,0, 0,f,0,0, 0,0,(zf+zn)/(zn-zf),-1,
0,0,2*zf*zn/(zn-zf),0];
// mvp = P * R  (column major)
const M=new Array(16).fill(0);
for(let c=0;c<4;c++)for(let r=0;r<4;r++)for(let k=0;k<4;k++)
M[c*4+r]+=Pm[k*4+r]*R[c*4+k];
return [M,R];}
buf('p',P,3);buf('n',N,3);buf('col',C,3);
function draw(){const[M,R]=mat();
gl.viewport(0,0,cv.width,cv.height);
gl.clearColor(.09,.1,.12,1);
gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
gl.uniformMatrix4fv(gl.getUniformLocation(pr,'mvp'),false,M);
gl.uniformMatrix4fv(gl.getUniformLocation(pr,'mv'),false,R);
gl.drawArrays(MODE==='mesh'?gl.TRIANGLES:gl.POINTS,0,P.length/3);}
draw();
"""


def save_viewer_html(path: str, verts: np.ndarray,
                     faces: np.ndarray = None,
                     colors: np.ndarray = None,
                     title: str = "viewer") -> str:
    """Write a dependency-free interactive viewer page for a mesh
    (verts [n,3] + faces [m,3]) or point cloud (faces=None).

    Counterpart of the reference's pythreejs offline viewer
    (pythreejs_viewer.py:33-37 `offline()` + add_mesh/add_points): drag to
    orbit, wheel to zoom, Lambert shading from flat face normals.  All
    geometry is embedded in the file — openable anywhere with no network.
    """
    import json
    import os

    verts = np.asarray(verts, np.float32).reshape(-1, 3)
    if colors is not None:
        colors = np.asarray(colors, np.float32).reshape(-1, 3)
    if faces is not None:
        faces = np.asarray(faces, np.int64).reshape(-1, 3)
        # expand to flat-shaded triangle soup (uniform normals per face)
        tri = verts[faces.reshape(-1)]
        fn = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                      verts[faces[:, 2]] - verts[faces[:, 0]])
        fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
        nrm = np.repeat(fn, 3, axis=0)
        col = (colors[faces.reshape(-1)] if colors is not None
               else np.full_like(tri, 0.75))
        mode = "mesh"
    else:
        tri, nrm = verts, np.tile([0.0, 0.0, 1.0], (len(verts), 1))
        col = colors if colors is not None else np.full_like(tri, 0.75)
        mode = "points"

    def js_arr(a):
        return json.dumps(np.round(np.asarray(a, np.float64), 5)
                          .reshape(-1).tolist())

    body = (
        f"<canvas id='c' width='960' height='720'></canvas>"
        f"<script>const MODE={json.dumps(mode)};"
        f"const P={js_arr(tri)};const N={js_arr(nrm)};"
        f"const C={js_arr(col)};{_VIEWER_JS}</script>")
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"<html><head><meta charset='utf-8'/>"
                f"<title>{title}</title></head><body>{body}</body></html>")
    return path
