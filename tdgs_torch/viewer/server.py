"""Interactive splat viewer: a self-contained HTTP server (port of
``tdgs/viewer/server.py``).

A browser page with a free camera (drag to look, WASD/QE to move, the wheel
to dolly, O for the orbit mode) streams JPEG frames from any render
function. The render-tab knobs (SH degree, near and far planes,
radius_clip, eps2d, background colour, render mode rgb/depth/alpha) are URL
parameters and page controls, and a world-to-camera matrix can be given as
``?vm=<16 floats>`` for programmatic drives. The transport is the standard
library's ``ThreadingHTTPServer``; frames are encoded by PIL at quality 90.

    viewer = ViewerServer(render_fn, port=8080)
    viewer.serve_forever()          # or .start() for a background thread

where ``render_fn(viewmat [4, 4] np, K [3, 3] np, width, height,
RenderTabState) -> uint8 image [H, W, 3]``. ``make_splat_render_fn`` builds
one over a splat dict, rendered on the card through kernel 1 (3DGS), 4
(2DGS) or 7 (3DGUT), or on the CPU through their plain versions.
"""

from __future__ import annotations

import io
import threading
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from tdgs_torch._device import DeviceLike, as_float, resolve_device
from tdgs_torch.rendering import rasterization, rasterization_2dgs


@dataclass
class RenderTabState:
    """The render knobs (gsplat_viewer.py's GsplatRenderTabState)."""

    max_sh_degree: int = 3
    near_plane: float = 0.01
    far_plane: float = 1e10
    radius_clip: float = 0.0
    eps2d: float = 0.3
    backgrounds: tuple = (0.0, 0.0, 0.0)
    render_mode: str = "rgb"  # rgb | depth | alpha
    inverse_depth: bool = False
    colormap: str = "turbo"


_PAGE = """<!doctype html><html><head><title>tdgs viewer</title><style>
body{margin:0;background:#111;color:#ddd;font-family:monospace}
#c{display:block;margin:auto;cursor:grab}
#hud{position:fixed;top:8px;left:8px;background:#0008;padding:8px;line-height:1.8}
select,input{background:#222;color:#ddd;border:1px solid #444}
input[type=number]{width:4.5em}
</style></head><body>
<div id="hud">
 <b>free camera</b> — drag: look &middot; WASD: move &middot; QE: up/down
 &middot; wheel: dolly &middot; shift: fast &middot; O: orbit mode<br>
 mode <select id="mode"><option>rgb</option><option>depth</option><option>alpha</option></select>
 sh <input id="sh" type="number" min="0" max="4" value="3">
 near <input id="near" type="number" value="0.01" step="0.01">
 far <input id="far" type="number" value="1e10">
 rclip <input id="rclip" type="number" value="0" step="0.5">
 eps2d <input id="eps2d" type="number" value="0.3" step="0.1">
 bg <input id="bg" type="color" value="#000000">
 <span id="fps"></span>
</div>
<img id="c" width="{W}" height="{H}" tabindex="0">
<script>
// free (fly) camera: position + yaw/pitch, z-up world, OpenCV camera.
// O toggles the legacy orbit mode (azimuth/elevation/distance).
let pos=[6,0,2], yaw=Math.PI, pitch=-0.3;
let orbit=false, az=0.0, el=0.3, dist=6.0;
let drag=null, pending=false, dirty=false, t0=0;
const img=document.getElementById('c');
const v=id=>document.getElementById(id).value;
function knobs(){
  const bg=v('bg');
  const r=parseInt(bg.substr(1,2),16)/255, g=parseInt(bg.substr(3,2),16)/255,
        b=parseInt(bg.substr(5,2),16)/255;
  return `&mode=${v('mode')}&sh=${v('sh')}&near=${v('near')}&far=${v('far')}`+
         `&rclip=${v('rclip')}&eps2d=${v('eps2d')}&bg=${r},${g},${b}`;
}
function url(){
  if(orbit)
    return `/render?az=${az}&el=${el}&dist=${dist}`+knobs()+`&_=${Math.random()}`;
  return `/render?px=${pos[0]}&py=${pos[1]}&pz=${pos[2]}`+
         `&yaw=${yaw}&pitch=${pitch}`+knobs()+`&_=${Math.random()}`;
}
function refresh(){
  if(pending){dirty=true; return;}
  pending=true; t0=performance.now();
  const u=url();
  const tmp=new Image();
  tmp.onload=()=>{img.src=u; pending=false;
    document.getElementById('fps').textContent=((performance.now()-t0)|0)+' ms';
    if(dirty){dirty=false; refresh();}};
  tmp.onerror=()=>{pending=false;};
  tmp.src=u;
}
function axes(){ // camera forward/right in world (z-up)
  const cf=[Math.cos(yaw)*Math.cos(pitch), Math.sin(yaw)*Math.cos(pitch),
            Math.sin(pitch)];
  const rt=[Math.sin(yaw), -Math.cos(yaw), 0];
  return [cf, rt];
}
img.onmousedown=e=>{drag=[e.clientX,e.clientY];img.focus();e.preventDefault()};
window.onmouseup=()=>drag=null;
window.onmousemove=e=>{if(!drag)return;
  if(orbit){az+=(e.clientX-drag[0])*0.01; el+=(e.clientY-drag[1])*0.01;
    el=Math.max(-1.5,Math.min(1.5,el));}
  else{yaw-=(e.clientX-drag[0])*0.005; pitch-=(e.clientY-drag[1])*0.005;
    pitch=Math.max(-1.55,Math.min(1.55,pitch));}
  drag=[e.clientX,e.clientY]; refresh();};
img.onwheel=e=>{
  if(orbit){dist*=Math.exp(e.deltaY*0.001);}
  else{const [cf]=axes(); const s=-e.deltaY*0.003;
    pos=[pos[0]+cf[0]*s,pos[1]+cf[1]*s,pos[2]+cf[2]*s];}
  refresh(); e.preventDefault();};
window.onkeydown=e=>{
  if(e.target.tagName==='INPUT'||e.target.tagName==='SELECT') return;
  if(e.key==='o'||e.key==='O'){orbit=!orbit; refresh(); return;}
  const s=(e.shiftKey?1.0:0.25);
  const [cf,rt]=axes();
  const mv={w:cf, s:cf.map(x=>-x), d:rt, a:rt.map(x=>-x),
            q:[0,0,1], e:[0,0,-1]}[e.key.toLowerCase()];
  if(!mv) return;
  pos=[pos[0]+mv[0]*s, pos[1]+mv[1]*s, pos[2]+mv[2]*s];
  refresh(); e.preventDefault();
};
for(const id of ['mode','sh','near','far','rclip','eps2d','bg'])
  document.getElementById(id).onchange=refresh;
refresh();
</script></body></html>"""


def fly_camera(pos: np.ndarray, yaw: float, pitch: float) -> np.ndarray:
    """World-to-camera [4, 4] of a free camera at ``pos`` looking along
    (yaw, pitch): z-up world, OpenCV camera."""
    eye = np.asarray(pos, np.float32)
    fwd = np.array(
        [np.cos(yaw) * np.cos(pitch), np.sin(yaw) * np.cos(pitch),
         np.sin(pitch)], np.float32,
    )
    fwd = fwd / (np.linalg.norm(fwd) + 1e-12)
    up = np.array([0, 0, 1], np.float32)
    right = np.cross(fwd, up)
    nrm = np.linalg.norm(right)
    if nrm < 1e-6:  # looking straight up/down: pick a stable right
        right = np.array([np.sin(yaw), -np.cos(yaw), 0], np.float32)
    else:
        right = right / nrm
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])
    t = -R @ eye
    vm = np.eye(4, dtype=np.float32)
    vm[:3, :3] = R
    vm[:3, 3] = t
    return vm


def orbit_camera(az: float, el: float, dist: float, target: np.ndarray):
    """World-to-camera [4, 4] of an orbit camera (z-up world, OpenCV
    camera) at azimuth ``az``, elevation ``el`` and ``dist`` from
    ``target``."""
    cx = np.cos(az) * np.cos(el)
    cy = np.sin(az) * np.cos(el)
    cz = np.sin(el)
    eye = target + dist * np.array([cx, cy, cz], np.float32)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0, 0, 1], np.float32)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right) + 1e-12
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])  # rows: cam x(right), y(down), z(fwd)
    t = -R @ eye
    vm = np.eye(4, dtype=np.float32)
    vm[:3, :3] = R
    vm[:3, 3] = t
    return vm


def encode_jpeg(img: np.ndarray) -> bytes:
    """A uint8 [H, W, 3] frame as JPEG bytes at quality 90, chroma at full
    resolution (4:4:4): with PIL's default 4:2:0 a frame of many small
    splats of unrelated colours decodes 2.5-4.6 levels off on average
    (the 1080p bench scene on the H100), with 4:4:4 closer."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=90, subsampling=0)
    return buf.getvalue()


class ViewerServer:
    """Serves the page at ``/`` and frames at ``/render`` from
    ``render_fn``, one render at a time (``lock``). A failed render answers
    500 with its traceback. ``host`` is the address to bind."""

    def __init__(
        self,
        render_fn: Callable,
        width: int = 960,
        height: int = 540,
        port: int = 8080,
        focal: Optional[float] = None,
        target=(0.0, 0.0, 0.0),
        state: Optional[RenderTabState] = None,
        host: str = "0.0.0.0",
    ):
        self.render_fn = render_fn
        self.width = width
        self.height = height
        self.port = port
        self.focal = focal or 1.1 * max(width, height)
        self.target = np.asarray(target, np.float32)
        self.state = state or RenderTabState()
        self.lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/":
                    body = _PAGE.replace("{W}", str(outer.width)).replace(
                        "{H}", str(outer.height)).encode()
                    self._reply(200, "text/html", body)
                elif u.path == "/render":
                    try:
                        q = {k: v[0] for k, v in parse_qs(u.query).items()}
                        body = encode_jpeg(outer._render(q))
                    except Exception:  # the server keeps serving; the client reads why
                        import traceback

                        self._reply(500, "text/plain", traceback.format_exc().encode())
                        return
                    self._reply(200, "image/jpeg", body)
                else:
                    self.send_response(404)
                    self.end_headers()

            def _reply(self, code: int, content_type: str, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]  # the port bound (port 0: a free one)

    def _render(self, q) -> np.ndarray:
        st = self.state
        st.render_mode = q.get("mode", st.render_mode)
        st.max_sh_degree = int(q.get("sh", st.max_sh_degree))
        if "near" in q:
            st.near_plane = float(q["near"])
        if "far" in q:
            st.far_plane = float(q["far"])
        if "rclip" in q:
            st.radius_clip = float(q["rclip"])
        if "eps2d" in q:
            st.eps2d = float(q["eps2d"])
        if "bg" in q:
            st.backgrounds = tuple(float(x) for x in q["bg"].split(","))
        # resolution override (nerfview's max-img-res knob)
        width = max(16, min(int(q.get("w", self.width)), 4096))
        height = max(16, min(int(q.get("h", self.height)), 4096))
        if "vm" in q:
            # programmatic arbitrary pose: 16 comma floats, row-major w2c
            vm = np.asarray([float(x) for x in q["vm"].split(",")], np.float32).reshape(4, 4)
        elif "yaw" in q or "px" in q:
            # free (fly) camera: position + yaw/pitch
            vm = fly_camera(
                np.array([float(q.get("px", 6)), float(q.get("py", 0)),
                          float(q.get("pz", 2))], np.float32),
                float(q.get("yaw", np.pi)), float(q.get("pitch", -0.3)),
            )
        else:
            vm = orbit_camera(
                float(q.get("az", 0)), float(q.get("el", 0.3)),
                float(q.get("dist", 6)), self.target
                + np.array([float(q.get("tx", 0)), float(q.get("ty", 0)),
                            float(q.get("tz", 0))], np.float32),
            )
        K = self.intrinsics(width, height)
        with self.lock:  # render serially (shared device)
            img = self.render_fn(vm, K, width, height, st)
        return np.ascontiguousarray(img)

    def intrinsics(self, width: int, height: int) -> np.ndarray:
        """The pinhole K of a ``width`` x ``height`` frame: the focal length
        scaled with the width, the principal point at the centre."""
        f = self.focal * width / self.width
        return np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]], np.float32)

    def serve_forever(self):
        print(f"tdgs_torch viewer at http://localhost:{self.port}", flush=True)
        self.httpd.serve_forever()

    def start(self) -> threading.Thread:
        th = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        th.start()
        return th

    def shutdown(self):
        """Stop serving and close the socket."""
        self.httpd.shutdown()
        self.httpd.server_close()


def frame_to_uint8(img, alpha, render_mode: str, inverse_depth: bool = False) -> np.ndarray:
    """A render's first image → the uint8 [H, W, 3] frame the viewer sends:
    "rgb" its first three channels, "depth" its last channel scaled by the
    2nd and 98th percentiles of the positive depths (inverted with
    ``inverse_depth``), "alpha" the alpha, each clipped to [0, 1]. The
    depth's percentiles are taken on the host (numpy's); rgb and alpha are
    converted where they lie and copied as uint8."""
    if render_mode == "depth":
        d = img[0, ..., -1].detach().cpu().numpy()
        lo, hi = np.percentile(d[d > 0], [2, 98]) if (d > 0).any() else (0, 1)
        d = np.clip((d - lo) / max(hi - lo, 1e-6), 0, 1)
        if inverse_depth:
            d = 1.0 - d
        out = np.stack([d, d, d], -1)
        return (np.clip(out, 0, 1) * 255).astype(np.uint8)
    out = alpha[0, ..., :1].expand(-1, -1, 3) if render_mode == "alpha" else img[0, ..., :3]
    return (torch.clamp(out.detach(), 0, 1) * 255).to(torch.uint8).cpu().numpy()


def viewer_rasterizer(model_type: str, device: torch.device) -> str:
    """The forward-only rasterizer of a viewer family: on the card kernel 1
    ("packed_inference", 3DGS), kernel 4 ("packed_inference", 2DGS) or
    kernel 7 ("eval3d_packed", 3DGUT); on the CPU the plain tensor routes
    ("jax", or "eval3d" for 3DGUT)."""
    on_card = device.type == "cuda"
    if model_type == "3dgut":
        return "eval3d_packed" if on_card else "eval3d"
    return "packed_inference" if on_card else "jax"


def make_splat_render_fn(splats, rasterizer: str = "auto", model_type: str = "3dgs",
                         device: DeviceLike = None):
    """A ``render_fn`` over a raw splat dict (means, quats, log scales,
    logit opacities, sh0, shN: tensors or arrays, taken to ``device``).
    ``model_type`` is the render family: "3dgs", "2dgs" (surfels) or
    "3dgut" (world-space eval3d); ``rasterizer="auto"`` takes
    ``viewer_rasterizer``'s. Every mode passes the tab's background; "depth"
    renders "RGB+ED" and shows its last channel. Renders without autograd."""
    if model_type not in ("3dgs", "2dgs", "3dgut"):
        raise ValueError(f"model_type {model_type!r}")
    dev = resolve_device(device)
    sp = {k: as_float(splats[k], dev)
          for k in ("means", "quats", "scales", "opacities", "sh0", "shN")}
    means, quats = sp["means"], sp["quats"]
    scales, opacities = torch.exp(sp["scales"]), torch.sigmoid(sp["opacities"])
    sh = torch.cat([sp["sh0"], sp["shN"]], dim=-2)
    if rasterizer == "auto":
        rasterizer = viewer_rasterizer(model_type, dev)

    @torch.no_grad()
    def render_fn(viewmat, K, width, height, st: RenderTabState):
        mode = {"rgb": "RGB", "depth": "RGB+ED", "alpha": "RGB"}[st.render_mode]
        common = dict(
            sh_degree=min(st.max_sh_degree, 3), near_plane=st.near_plane,
            far_plane=st.far_plane, render_mode=mode, radius_clip=st.radius_clip,
            backgrounds=torch.tensor(st.backgrounds, dtype=torch.float32, device=dev)[None],
            rasterizer=rasterizer, device=dev,
        )
        cams = (torch.as_tensor(viewmat, dtype=torch.float32, device=dev)[None],
                torch.as_tensor(K, dtype=torch.float32, device=dev)[None], width, height)
        if model_type == "2dgs":
            out = rasterization_2dgs(means, quats, scales, opacities, sh, *cams, **common)
            img, alpha = out[0], out[1]
        else:
            img, alpha, _ = rasterization(means, quats, scales, opacities, sh, *cams,
                                          eps2d=st.eps2d, **common)
        return frame_to_uint8(img, alpha, st.render_mode)

    return render_fn
