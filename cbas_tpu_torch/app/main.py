"""Application entry point.

With Eel installed + a frontend directory, serves the websocket UI exactly
like the reference shell expects (it scrapes stdout for the server line,
reference: main.js:87). Headless, it loads the project, starts the workers,
and keeps pumping until interrupted — the mode used for server
deployments where the UI runs elsewhere.

    python -m cbas_tpu_torch.app.main --project /path/to/project [--frontend dir] [--port N]
        [--device {cuda,cpu}]

The encoder, inference and training run on CUDA: over a mesh of the visible
cards when there are several or ``runtime.mesh_shape`` asks for one, else on
one card. Without a card the app exits unless ``--device cpu`` asks for the
CPU.
"""

from __future__ import annotations

import argparse
import sys
import time

from cbas_tpu_torch.app.api import Api, bind_eel, bridge_callbacks_to_eel
from cbas_tpu_torch.utils.logging import log_message


def _frontend_uses_eel(frontend_dir: str) -> bool:
    """True iff the asset dir contains an eel-style page (references /eel.js).

    That is the carry-over path for reference-style frontends; the bundled
    ``frontend/`` is JSON-RPC/SSE-based and must be served by RpcServer.
    """
    import glob
    import os

    if not os.path.isdir(frontend_dir):
        return False
    for page in glob.glob(os.path.join(frontend_dir, "*.html")):
        try:
            with open(page, "r", encoding="utf-8", errors="ignore") as f:
                if "/eel.js" in f.read():
                    return True
        except OSError:
            continue
    return False


def find_available_port(start: int = 8000) -> int:
    import socket

    for port in range(start, start + 200):
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            try:
                s.bind(("localhost", port))
                return port
            except OSError:
                continue
    raise RuntimeError("no available port")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--project", default=None, help="project directory to open")
    parser.add_argument("--frontend", default="frontend", help="frontend asset dir")
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--headless", action="store_true")
    parser.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the encoder, inference and training run (default: cuda)",
    )
    args = parser.parse_args(argv)

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        log_message(
            "No CUDA device is visible; pass --device cpu to run on the CPU.", "ERROR"
        )
        sys.exit(2)

    # Operational diagnostic: `kill -USR1 <pid>` dumps every thread's Python
    # stack to stderr without disturbing the process — the tool for "a worker
    # stopped making progress" reports from long-running deployments.
    try:
        import faulthandler
        import signal

        faulthandler.register(signal.SIGUSR1, all_threads=True)
    except (ImportError, AttributeError, ValueError):
        pass  # non-POSIX or signal unavailable; diagnostics only

    api = Api(device=args.device)
    if args.project:
        result = api.load_project(args.project)
        if not result.get("success"):
            log_message(f"Could not load project: {result.get('message')}", "ERROR")
            sys.exit(1)

    # Eel mode exists to serve an *eel-based* frontend (the reference's
    # five-page UI, whose JS loads /eel.js). The bundled frontend/ talks
    # JSON-RPC + SSE instead, so it must be served by RpcServer — running it
    # under Eel would 404 every /api call. Pick by inspecting the assets.
    use_eel = False
    if not args.headless and _frontend_uses_eel(args.frontend):
        try:
            import eel

            eel.init(args.frontend)
            bind_eel(api)
            bridge_callbacks_to_eel(api)
            use_eel = True
        except Exception as e:
            log_message(f"Eel unavailable ({e}); serving the built-in UI.", "WARN")

    if use_eel:
        import eel

        port = args.port or find_available_port()
        print(f"Eel server starting on http://localhost:{port}")
        # mode=None: never spawn a browser — the desktop shell (or the user)
        # owns the window; eel's default tries to launch Chrome and raises
        # (killing the backend) on machines without it.
        eel.start("index.html", port=port, mode=None, block=True)
    else:
        # Built-in JSON-RPC + SSE server with the embedded control panel.
        from cbas_tpu_torch.app.server import RpcServer

        import os

        server = RpcServer(
            api,
            port=args.port or 0,
            frontend_dir=args.frontend if os.path.isdir(args.frontend) else None,
        )
        port = server.start()
        print(f"Eel server starting on http://localhost:{port}")  # shell contract
        try:
            while True:
                if api.state.shutdown.wait(timeout=1.0):
                    # Grace window: kill_all_processes + load_project is the
                    # documented in-place revival flow — if a load_project
                    # clears the flag within a few seconds, keep serving
                    # instead of racing the client to process exit.
                    time.sleep(5.0)
                    if api.state.shutdown.is_set():
                        break
        except KeyboardInterrupt:
            pass
        finally:
            server.stop()
            api.kill_all_processes()


if __name__ == "__main__":
    main()
