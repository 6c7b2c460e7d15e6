"""Static files under a route prefix (counterpart of
gofr_tpu/staticfiles.py): ``GET <route>/{filepath...}`` serves the file
under the directory (``index.html`` for the directory itself), 404 when
absent, 403 for a path that leaves the directory."""

from __future__ import annotations

import mimetypes
import os

from .http.request import Request
from .http.responder import Response, to_json_bytes


def register_static_route(app, route: str, directory: str) -> None:
    directory = os.path.abspath(directory)
    route = "/" + route.strip("/")

    async def static_handler(req: Request) -> Response:
        rel = req.path_params.get("filepath", "") or "index.html"
        full = os.path.abspath(os.path.join(directory, rel))
        if not full.startswith(directory + os.sep) and full != directory:
            return Response(403, [("Content-Type", "application/json")], to_json_bytes({"error": {"message": "forbidden"}}))
        if os.path.isdir(full):
            full = os.path.join(full, "index.html")
        if not os.path.isfile(full):
            return Response(404, [("Content-Type", "application/json")], to_json_bytes({"error": {"message": "file not found"}}))
        ctype = mimetypes.guess_type(full)[0] or "application/octet-stream"
        with open(full, "rb") as f:
            return Response(200, [("Content-Type", ctype)], f.read())

    app.router.add("GET", f"{route}/{{filepath...}}", static_handler)
