"""Built-in web server: JSON-RPC over HTTP + server-sent events.

The reference serves its UI through Eel's websocket bridge (backend/app.py);
this stdlib-only equivalent exposes the same :class:`Api` surface so the
framework is fully drivable from a browser or ``curl`` with zero extra
dependencies:

    POST /api/<method>      body: {"args": [...], "kwargs": {...}}
    GET  /events            SSE stream of UI callbacks + log lines
    GET  /                  minimal built-in control panel

Numpy scalars/arrays in results are JSON-sanitized. Every callback the workers
emit (progress, notifications) is fanned out to all connected SSE clients.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from cbas_tpu_torch.app.api import Api
from cbas_tpu_torch.utils.logging import log_message, log_queue


def _sanitize(obj):
    if isinstance(obj, dict):
        return {str(k): _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>CBAS-TPU</title>
<style>
 body{font-family:system-ui,sans-serif;background:#22262b;color:#e6e6e6;margin:0;padding:1rem}
 h1{font-size:1.2rem} section{background:#2c3137;border-radius:8px;padding:1rem;margin:0 0 1rem}
 button{background:#3d6fb4;color:#fff;border:0;border-radius:4px;padding:.4rem .8rem;margin:.2rem;cursor:pointer}
 input,select{background:#22262b;color:#e6e6e6;border:1px solid #555;border-radius:4px;padding:.3rem}
 pre{background:#17191c;padding:.5rem;max-height:16rem;overflow:auto;font-size:.75rem}
 img{max-width:100%}
 .row{display:flex;gap:1rem;flex-wrap:wrap} .col{flex:1;min-width:20rem}
</style></head><body>
<h1>CBAS-TPU control panel</h1>
<div class="row"><div class="col">
<section><h2>Status</h2><pre id="status">...</pre>
 <button onclick="call('get_cbas_status').then(show('status'))">Refresh</button>
 <button onclick="call('get_metrics').then(show('status'))">Metrics</button>
 <button onclick="call('reload_project_data').then(show('status'))">Reload project</button>
</section>
<section><h2>Datasets</h2><pre id="datasets">...</pre>
 <button onclick="call('load_dataset_configs').then(show('datasets'))">List</button>
</section>
<section><h2>Train</h2>
 dataset <input id="tds" value=""> seq <input id="tseq" value="31" size="3">
 epochs <input id="tep" value="10" size="3">
 <button onclick="train()">Train</button>
 <button onclick="call('cancel_training_task', val('tds'))">Cancel</button>
 <pre id="train">idle</pre>
</section></div>
<div class="col">
<section><h2>Inference</h2>
 model <input id="imodel"> dirs (csv) <input id="idirs">
 <button onclick="call('start_classification', val('imodel'), val('idirs').split(',')).then(show('infer'))">Run</button>
 <pre id="infer">idle</pre>
</section>
<section><h2>Actogram</h2>
 root <input id="aroot"> subject <input id="asub"> model <input id="amodel">
 behavior <input id="abeh"> fps <input id="afps" value="10" size="4">
 bin(min) <input id="abin" value="60" size="3"> thr <input id="athr" value="0.5" size="3">
 <button onclick="acto()">Generate</button>
 <div id="acto"></div>
</section>
<section><h2>Event log</h2><pre id="log"></pre></section>
</div></div>
<script>
const val=id=>document.getElementById(id).value;
const show=id=>r=>{document.getElementById(id).textContent=JSON.stringify(r,null,1)};
async function call(method,...args){
  const r=await fetch('/api/'+method,{method:'POST',body:JSON.stringify({args})});
  const j=await r.json(); if(j.error) throw new Error(j.error); return j.result;
}
async function callKw(method, args, kwargs){
  const r=await fetch('/api/'+method,{method:'POST',body:JSON.stringify({args,kwargs})});
  const j=await r.json(); if(j.error) throw new Error(j.error); return j.result;
}
function train(){
  callKw('train_model', [val('tds')], {sequence_length:+val('tseq'), epochs:+val('tep')})
    .then(show('train')).catch(e=>show('train')(String(e)));
}
function acto(){
  call('generate_actograms', val('aroot'), val('asub'), val('amodel'), [val('abeh')],
       +val('afps'), +val('abin'), 0, +val('athr'), 'LD', false, Date.now())
    .then(r=>{const d=document.getElementById('acto'); d.innerHTML='';
      for(const b in (r||{})){const img=document.createElement('img');
        img.src='data:image/png;base64,'+r[b]; d.appendChild(img);}});
}
const log=document.getElementById('log');
const es=new EventSource('/events');
es.onmessage=e=>{const d=JSON.parse(e.data);
  const line = d.name==='log_line' ? d.args[0]
             : '['+d.name+'] '+JSON.stringify(d.args).slice(0,200);
  log.textContent=line+'\\n'+log.textContent;
  log.textContent=log.textContent.split('\\n').slice(0,200).join('\\n');};
call('get_cbas_status').then(show('status'));
</script></body></html>
"""


_MIME = {
    ".html": "text/html; charset=utf-8",
    ".js": "text/javascript; charset=utf-8",
    ".css": "text/css; charset=utf-8",
    ".png": "image/png",
    ".jpg": "image/jpeg",
    ".svg": "image/svg+xml",
    ".ico": "image/x-icon",
}


class RpcServer:
    """Threaded HTTP server exposing one Api instance.

    ``frontend_dir``: directory of static UI assets (the full five-page app
    in ``frontend/``). When absent, the embedded single-page control panel
    above is served at ``/`` so the API is always browsable.
    """

    def __init__(
        self,
        api: Api,
        host: str = "localhost",
        port: int = 0,
        frontend_dir: Optional[str] = None,
    ):
        self.api = api
        if frontend_dir is None:
            candidate = os.path.join(
                os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                "frontend",
            )
            frontend_dir = candidate if os.path.isdir(candidate) else None
        self.frontend_dir = frontend_dir
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # silence per-request noise
                pass

            def _send_json(self, payload, code=200):
                body = json.dumps(_sanitize(payload)).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/events":
                    # Same rebinding guard as POST: /events carries log lines
                    # (project paths) and base64 frame payloads — a DNS-
                    # rebound page's EventSource is same-origin to the
                    # browser and would read the whole stream otherwise.
                    if not self._origin_ok():
                        self._send_json({"error": "forbidden origin"}, 403)
                        return
                    self._serve_events()
                    return
                path = self.path.split("?", 1)[0]
                if path == "/":
                    path = "/index.html"
                if outer.frontend_dir is not None and self._serve_static(path):
                    return
                if path == "/index.html":
                    body = INDEX_HTML.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._send_json({"error": "not found"}, 404)

            def _serve_static(self, path: str) -> bool:
                root = os.path.realpath(outer.frontend_dir)
                target = os.path.realpath(os.path.join(root, path.lstrip("/")))
                # Containment check: reject traversal outside the asset dir.
                if not (target == root or target.startswith(root + os.sep)):
                    return False
                if not os.path.isfile(target):
                    return False
                with open(target, "rb") as f:
                    body = f.read()
                ext = os.path.splitext(target)[1].lower()
                self.send_response(200)
                self.send_header(
                    "Content-Type", _MIME.get(ext, "application/octet-stream")
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return True

            def _serve_events(self):
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                q: "queue.Queue" = queue.Queue(maxsize=500)

                def listener(name, args):
                    try:
                        q.put_nowait({"name": name, "args": _sanitize(list(args))})
                    except queue.Full:
                        pass

                outer.api.state.callbacks.add_listener(listener)
                try:
                    import time as _time

                    last_ping = _time.monotonic()
                    while not outer.api.state.shutdown.is_set():
                        try:
                            item = q.get(timeout=0.5)
                        except queue.Empty:
                            # Periodic keepalive comment: a dead socket only
                            # surfaces on write, so an idle disconnected
                            # client would otherwise leak this thread and its
                            # callbacks listener forever.
                            now = _time.monotonic()
                            if now - last_ping >= 15.0:
                                self.wfile.write(b": ping\n\n")
                                self.wfile.flush()
                                last_ping = now
                            continue
                        data = json.dumps(item)
                        self.wfile.write(f"data: {data}\n\n".encode())
                        self.wfile.flush()
                        last_ping = _time.monotonic()
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass
                finally:
                    outer.api.state.callbacks.remove_listener(listener)
                    # Close the connection when the loop exits (shutdown):
                    # the listener is gone, so letting HTTP/1.1 keep-alive
                    # fall back to the request loop would leave a surviving
                    # EventSource open-but-deaf after the kill_all_processes
                    # + load_project revival flow. Closing sends FIN and the
                    # browser's EventSource auto-reconnects.
                    self.close_connection = True

            def _origin_ok(self) -> bool:
                """CSRF/DNS-rebinding guard: API POSTs must come from our own
                pages (same-origin/localhost Origin) or from non-browser
                clients (no Origin header, e.g. curl). A malicious web page's
                cross-origin fetch carries its own Origin and is rejected
                before any state-changing method runs. The Host header must
                also name localhost — a rebound DNS name fails this."""
                from urllib.parse import urlsplit

                try:
                    # urlsplit handles bracketed IPv6 ("[::1]:8123" -> "::1");
                    # naive split(":") would yield "[" and 403 IPv6 loopback.
                    host = urlsplit("//" + (self.headers.get("Host") or "")).hostname
                except ValueError:
                    return False
                if host not in ("localhost", "127.0.0.1", "::1", None):
                    return False
                origin = self.headers.get("Origin")
                if origin is None:
                    return True
                try:
                    from urllib.parse import urlparse

                    o = urlparse(origin)
                    return o.hostname in ("localhost", "127.0.0.1", "::1")
                except Exception:
                    return False

            def do_POST(self):
                if not self._origin_ok():
                    self._send_json({"error": "forbidden origin"}, 403)
                    return
                if not self.path.startswith("/api/"):
                    self._send_json({"error": "not found"}, 404)
                    return
                method = self.path[len("/api/") :]
                if method.startswith("_") or not hasattr(outer.api, method):
                    self._send_json({"error": f"unknown method: {method}"}, 404)
                    return
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                    payload = json.loads(self.rfile.read(length) or b"{}")
                    args = payload.get("args", [])
                    kwargs = payload.get("kwargs", {})
                    result = getattr(outer.api, method)(*args, **kwargs)
                    self._send_json({"result": result})
                except Exception as e:
                    self._send_json({"error": f"{type(e).__name__}: {e}"}, 500)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()

    def _log_broadcaster(self) -> None:
        """Fan log lines out through the callback bus so every SSE client
        receives every line (per-client drains of the single log_queue would
        deliver each line to only one client).

        Keyed on the SERVER's lifetime, not state.shutdown: a
        kill_all_processes + load_project revival clears state.shutdown and
        reconnected SSE clients keep working — a broadcaster that exited on
        the first shutdown would freeze the log panel for the process life.
        """
        while not self._stopped.is_set():
            try:
                line = log_queue.get(timeout=0.5)
            except queue.Empty:
                continue
            self.api.state.callbacks.emit("log_line", line)

    def start(self) -> int:
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        threading.Thread(target=self._log_broadcaster, daemon=True).start()
        log_message(f"CBAS-TPU server listening on http://localhost:{self.port}")
        return self.port

    def stop(self) -> None:
        self._stopped.set()
        self._httpd.shutdown()
        self._httpd.server_close()
