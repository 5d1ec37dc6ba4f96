"""Live odometry viewer: a periodically-updating HTTP view of a run.

TPU-host analogue of the reference's interactive GUI
(module/src/LidarOdometry.cpp:1637-2077: nanogui window with the decimated
local-map render, trajectory polyline, stats label block, and pause /
resume / save-map controls).  Headless hosts can't open a window, so the
same surface is served over HTTP instead:

  * ``/``              — self-refreshing page: latest snapshot + stats
  * ``/view3d``        — interactive WebGL 3D scene (orbit/zoom, local-map
    points colored by z, trajectory polyline, vehicle marker, camera-follow
    toggle — the reference GUI's 3D viewport, :1637-1836; self-contained
    inline WebGL, no external assets)
  * ``/points.json``   — decimated local-map points + trajectory + pose
  * ``/snapshot.png``  — most recent top-down render (in-memory PNG)
  * ``/stats.json``    — the GUI label block as JSON (quality, sigma,
    est. range, Hz, speed — the reference's five stat labels, :1841-1862)
  * ``/pause`` ``/resume``       — viewer-side pause of the driving loop
  * ``/toggle_active``           — the GUI "active" checkbox (:1941-1943):
    inactive discards incoming observations at the module
  * ``/toggle_mapping``          — the GUI "generate map" checkbox
    (:1944-1961): localization-only against the frozen local map
  * ``/save_map?path=...``       — the "save map" button (:2005-2013)
  * ``/save_trajectory?path=...``— the "save trajectory" button
  * ``/reset``                   — the GUI reset button (:1965-1977)

Control requests mirror how the reference marshals GUI mutations onto the
odometry thread (``enqueue_request``, :2216-2245): they only set flags /
enqueue closures; the driving loop calls :meth:`LiveViewer.on_frame`
between scans, which honors the pause flag, drains the request queue, and
re-renders every ``every_n`` frames.

Port of ``mola_lidar_odometry_tpu/utils/live_viz.py``.  The port's carry
lives on the card and the driving thread updates it in place, so the HTTP
thread never reads it: :meth:`LiveViewer.on_frame` (and the constructor)
copy the stats block to the host between scans, the decimated map only on
the frames that render (every ``every_n``, and at :meth:`render`), and the
HTTP handlers serve that copy.

Usage (the offline CLI wires this behind ``--live-viz PORT``)::

    viewer = LiveViewer(lo, every_n=10)
    viewer.start(port=8731)
    for scan in scans:
        lo.on_lidar_scan(...)
        viewer.on_frame()
    viewer.stop()
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

_PAGE = """<!DOCTYPE html>
<html><head><title>mola-lo-tpu live</title>
<style>body{{font-family:monospace;background:#111;color:#ddd;margin:1em}}
img{{max-width:70vw;border:1px solid #444}}
pre{{display:inline-block;vertical-align:top;margin-left:2em}}
a{{color:#8cf}}</style></head>
<body>
<h3>mola_lidar_odometry_tpu &mdash; live run &nbsp;
<a href="/view3d">[3d view]</a></h3>
<div>
<img id="snap" src="/snapshot.png" alt="waiting for first snapshot...">
<pre id="stats"></pre>
</div>
<p><a href="#" onclick="fetch('/pause');return false">pause</a> |
<a href="#" onclick="fetch('/resume');return false">resume</a> |
<a href="#" onclick="fetch('/toggle_active');return false">toggle active</a> |
<a href="#" onclick="fetch('/toggle_mapping');return false">toggle mapping</a> |
<a href="#" onclick="fetch('/save_map?path=live_map.mm.npz');return false">save map</a> |
<a href="#" onclick="fetch('/save_trajectory?path=live_traj.tum');return false">save trajectory</a> |
<a href="#" onclick="if(confirm('reset odometry?'))fetch('/reset');return false">reset</a></p>
<script>
async function tick() {{
  try {{
    const r = await fetch('/stats.json');
    const s = await r.json();
    document.getElementById('stats').textContent =
        JSON.stringify(s, null, 2);
    document.getElementById('snap').src = '/snapshot.png?t=' + Date.now();
  }} catch (e) {{}}
}}
setInterval(tick, {period_ms});
tick();
</script></body></html>
"""


_VIEW3D = """<!DOCTYPE html>
<html><head><title>mola-lo-tpu 3d</title>
<style>body{margin:0;background:#0b0e14;color:#ddd;font-family:monospace}
#hud{position:fixed;top:8px;left:8px;z-index:2}
a{color:#8cf;margin-right:1em}canvas{display:block}</style></head>
<body>
<div id="hud">
  <a href="/">2d view</a>
  <a href="#" id="follow">camera-follow: ON</a>
  <span id="info"></span>
</div>
<canvas id="c"></canvas>
<script>
// minimal self-contained WebGL point renderer (no external assets):
// local-map points colored by z, trajectory polyline, vehicle marker.
const cv = document.getElementById('c');
const gl = cv.getContext('webgl');
const vs = `attribute vec3 p;attribute vec3 col;uniform mat4 mvp;
uniform float ps;varying vec3 vc;
void main(){gl_Position=mvp*vec4(p,1.);gl_PointSize=ps;vc=col;}`;
const fs = `precision mediump float;varying vec3 vc;
void main(){gl_FragColor=vec4(vc,1.);}`;
function sh(t,s){const o=gl.createShader(t);gl.shaderSource(o,s);
gl.compileShader(o);return o;}
const prog=gl.createProgram();
gl.attachShader(prog,sh(gl.VERTEX_SHADER,vs));
gl.attachShader(prog,sh(gl.FRAGMENT_SHADER,fs));
gl.linkProgram(prog);gl.useProgram(prog);
const aP=gl.getAttribLocation(prog,'p'),aC=gl.getAttribLocation(prog,'col');
const uM=gl.getUniformLocation(prog,'mvp'),uS=gl.getUniformLocation(prog,'ps');
let mapBuf=gl.createBuffer(),mapCol=gl.createBuffer(),nMap=0;
let trajBuf=gl.createBuffer(),nTraj=0;
let pose=[0,0,0];
let yaw=0.7,pitch=0.9,dist=40,center=[0,0,0],follow=true;
function mat(){ // perspective * orbit lookat
  const w=cv.width,h=cv.height,f=1.0/Math.tan(0.4),a=w/h,zn=0.5,zf=1000;
  const P=[f/a,0,0,0, 0,f,0,0, 0,0,(zf+zn)/(zn-zf),-1, 0,0,2*zf*zn/(zn-zf),0];
  const cx=center[0]+dist*Math.cos(pitch)*Math.cos(yaw);
  const cy=center[1]+dist*Math.cos(pitch)*Math.sin(yaw);
  const cz=center[2]+dist*Math.sin(pitch);
  let zx=cx-center[0],zy=cy-center[1],zz=cz-center[2];
  const zl=Math.hypot(zx,zy,zz);zx/=zl;zy/=zl;zz/=zl;
  let xx=-zy,xy=zx,xz=0;const xl=Math.hypot(xx,xy,xz)||1;xx/=xl;xy/=xl;
  const yx=zy*xz-zz*xy,yy=zz*xx-zx*xz,yz=zx*xy-zy*xx;
  const V=[xx,yx,zx,0, xy,yy,zy,0, xz,yz,zz,0,
    -(xx*cx+xy*cy+xz*cz),-(yx*cx+yy*cy+yz*cz),-(zx*cx+zy*cy+zz*cz),1];
  const M=new Float32Array(16); // P*V
  for(let i=0;i<4;i++)for(let j=0;j<4;j++){let s=0;
    for(let k=0;k<4;k++)s+=P[k*4+j]*V[i*4+k];M[i*4+j]=s;}
  return M;
}
function draw(){
  cv.width=innerWidth;cv.height=innerHeight;
  gl.viewport(0,0,cv.width,cv.height);
  gl.clearColor(0.043,0.055,0.078,1);gl.clear(gl.COLOR_BUFFER_BIT);
  if(follow)center=pose.slice();
  gl.uniformMatrix4fv(uM,false,mat());
  if(nMap){gl.uniform1f(uS,2.0);
    gl.bindBuffer(gl.ARRAY_BUFFER,mapBuf);
    gl.enableVertexAttribArray(aP);gl.vertexAttribPointer(aP,3,gl.FLOAT,false,0,0);
    gl.bindBuffer(gl.ARRAY_BUFFER,mapCol);
    gl.enableVertexAttribArray(aC);gl.vertexAttribPointer(aC,3,gl.FLOAT,false,0,0);
    gl.drawArrays(gl.POINTS,0,nMap);}
  if(nTraj){gl.uniform1f(uS,5.0);
    gl.bindBuffer(gl.ARRAY_BUFFER,trajBuf);
    gl.enableVertexAttribArray(aP);gl.vertexAttribPointer(aP,3,gl.FLOAT,false,0,0);
    gl.disableVertexAttribArray(aC);gl.vertexAttrib3f(aC,1.0,0.65,0.2);
    gl.drawArrays(gl.LINE_STRIP,0,nTraj);
    gl.drawArrays(gl.POINTS,nTraj-1,1);}
  requestAnimationFrame(draw);
}
let drag=false,lx=0,ly=0;
cv.onmousedown=e=>{drag=true;lx=e.clientX;ly=e.clientY;};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{if(!drag)return;
  yaw-=(e.clientX-lx)*0.008;pitch=Math.min(1.5,Math.max(0.05,pitch+(e.clientY-ly)*0.008));
  lx=e.clientX;ly=e.clientY;};
cv.onwheel=e=>{dist=Math.min(400,Math.max(3,dist*Math.exp(e.deltaY*0.001)));e.preventDefault();};
document.getElementById('follow').onclick=e=>{follow=!follow;
  e.target.textContent='camera-follow: '+(follow?'ON':'OFF');return false;};
async function refresh(){
  try{
    const r=await fetch('/points.json');const d=await r.json();
    pose=d.pose;
    const n=d.map.length/3;nMap=n;
    gl.bindBuffer(gl.ARRAY_BUFFER,mapBuf);
    gl.bufferData(gl.ARRAY_BUFFER,new Float32Array(d.map),gl.DYNAMIC_DRAW);
    const cols=new Float32Array(n*3);
    for(let i=0;i<n;i++){const z=d.map[i*3+2];
      const t=Math.min(1,Math.max(0,(z-d.zmin)/(d.zmax-d.zmin+1e-6)));
      cols[i*3]=0.2+0.8*t;cols[i*3+1]=0.5;cols[i*3+2]=1.0-0.8*t;}
    gl.bindBuffer(gl.ARRAY_BUFFER,mapCol);
    gl.bufferData(gl.ARRAY_BUFFER,cols,gl.DYNAMIC_DRAW);
    nTraj=d.traj.length/3;
    gl.bindBuffer(gl.ARRAY_BUFFER,trajBuf);
    gl.bufferData(gl.ARRAY_BUFFER,new Float32Array(d.traj),gl.DYNAMIC_DRAW);
    document.getElementById('info').textContent=
      ' pts:'+n+' poses:'+nTraj;
  }catch(e){}
}
setInterval(refresh,1500);refresh();draw();
</script></body></html>
"""


class LiveViewer:
    """Serve a live view of a running :class:`LidarOdometry` instance."""

    def __init__(self, lo, every_n: int = 10, refresh_ms: int = 1000):
        self.lo = lo
        self.every_n = max(1, int(every_n))
        self.refresh_ms = refresh_ms
        self.paused = threading.Event()
        self._png: Optional[bytes] = None
        self._save_requests: list = []
        self._frames_seen = 0
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._t0 = time.time()
        self._lock = threading.Lock()
        self._snap: dict = {}
        self._take_snapshot()

    # ---- host-side driving loop hooks ------------------------------------

    def enqueue_request(self, fn) -> None:
        """Queue a mutation to run on the odometry thread between scans
        (the reference's enqueue_request contract, :2216-2245)."""
        with self._lock:
            self._save_requests.append(fn)

    def on_frame(self) -> None:
        """Call between scans: honors pause, drains queued requests,
        refreshes the snapshot every ``every_n`` frames."""
        while self.paused.is_set():
            time.sleep(0.05)
        with self._lock:
            reqs, self._save_requests = self._save_requests, []
        for fn in reqs:
            fn()
        self._frames_seen += 1
        if self._frames_seen % self.every_n == 0:
            self.render()
        else:
            self._take_snapshot(points=False)

    def render(self) -> None:
        """Re-render the top-down snapshot into the in-memory buffer (and
        refresh the host copy of the map the 3D view serves)."""
        from mola_lidar_odometry_tpu_torch.utils.viz import render_snapshot

        self._take_snapshot()
        buf = io.BytesIO()
        render_snapshot(self.lo, buf, title=f"frame {self._frames_seen}")
        self._png = buf.getvalue()

    def _take_snapshot(self, points: bool = True, max_points: int = 20000) -> None:
        """Copy what the HTTP thread serves to the host (on the driving
        thread, between scans): the carry's stats block in one transfer and,
        when ``points``, the decimated map points in one more (else the 3D
        view keeps the last copy)."""
        import numpy as _np

        from mola_lidar_odometry_tpu_torch.utils.serialization import metric_map_points
        from mola_lidar_odometry_tpu_torch.utils.viz import host_stats

        lo = self.lo
        snap = dict(host_stats(lo), frames=lo.frames_processed, dropped=lo.frames_dropped,
                    traj=_np.asarray([e["t"] for e in lo.trajectory], _np.float32).reshape(-1, 3))
        if points:
            layers = list(metric_map_points(lo.carry.maps, max_points, anchor=lo.carry.pose_t[0]).values())
            pts = _np.concatenate(layers) if layers else _np.zeros((0, 3), _np.float32)
            snap["points"] = pts[:: len(pts) // max_points + 1] if len(pts) > max_points else pts
        with self._lock:
            self._snap = dict(self._snap, **snap)

    def points_payload(self) -> dict:
        """Decimated local-map points (the host copy of the last rendered
        frame) + trajectory + pose (of the last frame boundary) for the 3D
        view."""
        with self._lock:
            s = self._snap
        pts, traj = s["points"], s["traj"]
        zmin = float(pts[:, 2].min()) if len(pts) else 0.0
        zmax = float(pts[:, 2].max()) if len(pts) else 1.0
        return {
            "map": [round(float(v), 3) for v in pts.ravel()],
            "traj": [round(float(v), 3) for v in traj.ravel()],
            "pose": [round(float(v), 3) for v in s["pose_t"]],
            "zmin": zmin,
            "zmax": zmax,
        }

    def stats(self) -> dict:
        """The GUI label block (the host copy of the last frame boundary)."""
        import numpy as _np

        with self._lock:
            s = self._snap
        dt = time.time() - self._t0
        speed = float(_np.linalg.norm(s["twist"][:3]))
        return {
            "frames": s["frames"],
            "dropped": s["dropped"],
            "trajectory_poses": len(s["traj"]),
            "icp_quality": round(s["icp_quality"], 4),
            "icp_iterations": s["icp_iterations"],
            "sigma_m": round(s["sigma"], 4),
            "est_sensor_range_m": round(s["est_range"], 2),
            "speed_mps": round(speed, 3),
            "speed_kmh": round(speed * 3.6, 2),
            "pose_t": [round(float(v), 3) for v in s["pose_t"]],
            "wall_s": round(dt, 1),
            "hz": round(s["frames"] / dt, 2) if dt > 0 else 0.0,
            "paused": self.paused.is_set(),
            "active": bool(self.lo.active),
            "mapping": s["mapping"],
        }

    # ---- HTTP server ------------------------------------------------------

    def start(self, port: int = 8731, host: str = "127.0.0.1") -> int:
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/":
                    page = _PAGE.format(period_ms=viewer.refresh_ms)
                    self._send(200, "text/html", page.encode())
                elif u.path == "/view3d":
                    self._send(200, "text/html", _VIEW3D.encode())
                elif u.path == "/points.json":
                    self._send(
                        200, "application/json",
                        json.dumps(viewer.points_payload()).encode(),
                    )
                elif u.path == "/snapshot.png":
                    png = viewer._png
                    if png is None:
                        self._send(503, "text/plain", b"no snapshot yet")
                    else:
                        self._send(200, "image/png", png)
                elif u.path == "/stats.json":
                    self._send(
                        200, "application/json",
                        json.dumps(viewer.stats()).encode(),
                    )
                elif u.path == "/pause":
                    viewer.paused.set()
                    self._send(200, "text/plain", b"paused")
                elif u.path == "/resume":
                    viewer.paused.clear()
                    self._send(200, "text/plain", b"resumed")
                elif u.path == "/toggle_active":
                    # flips immediately (the reference checkbox writes the
                    # module flag under its own mutex, :1941-1943); the
                    # dispatcher reads it per observation
                    viewer.lo.active = not viewer.lo.active
                    self._send(
                        200, "text/plain",
                        f"active={viewer.lo.active}".encode(),
                    )
                elif u.path == "/toggle_mapping":
                    # the flag lives on the card: the host copy says what
                    # the toggle will set, the driving thread flips it
                    with viewer._lock:
                        new_state = not viewer._snap["mapping"]
                    viewer.enqueue_request(
                        lambda: viewer.lo.set_mapping_enabled(not viewer.lo.mapping_enabled)
                    )
                    self._send(
                        200, "text/plain", f"mapping={new_state} queued".encode()
                    )
                elif u.path == "/save_map":
                    q = parse_qs(u.query)
                    path = q.get("path", ["live_map.mm.npz"])[0]
                    viewer.enqueue_request(
                        lambda p=path: viewer.lo.save_local_map(p)
                    )
                    self._send(200, "text/plain", f"queued: {path}".encode())
                elif u.path == "/save_trajectory":
                    q = parse_qs(u.query)
                    path = q.get("path", ["live_traj.tum"])[0]
                    viewer.enqueue_request(
                        lambda p=path: viewer.lo.save_trajectory_tum(p)
                    )
                    self._send(200, "text/plain", f"queued: {path}".encode())
                elif u.path == "/reset":
                    viewer.enqueue_request(viewer.lo.reset)
                    self._send(200, "text/plain", b"reset queued")
                else:
                    self._send(404, "text/plain", b"not found")

            do_POST = do_GET

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self._httpd.server_address[1]

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
