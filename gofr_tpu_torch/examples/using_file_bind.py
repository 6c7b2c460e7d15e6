"""A multipart upload bound to a dataclass (counterpart of
examples/using-file-bind/main.py).

    python -m gofr_tpu_torch.examples.using_file_bind

``POST /upload`` (multipart/form-data) binds the zip part ``upload``
(unpacked in memory) and the file part ``a``, and answers the zip's entry
names and the file's name and text; 400 when either is missing. HTTP on
9126, metrics on 9127.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..app import App, new
from ..config import Config
from ..fileutil import Zip
from ..http.errors import ErrorMissingParam
from ..http.request import UploadedFile
from . import DefaultsConfig

DEFAULTS = {"APP_NAME": "using-file-bind", "HTTP_PORT": "9126", "METRICS_PORT": "9127", "LOG_LEVEL": "INFO"}


@dataclass
class Data:
    # the field name is the form key unless `file` metadata names another
    upload: Zip = None
    a: UploadedFile = None


def upload_handler(ctx):
    d = ctx.bind(Data)
    if d.upload is None or d.a is None:
        raise ErrorMissingParam("upload", "a")
    return {
        "zip_entries": sorted(d.upload.files),
        "file_name": d.a.filename,
        "file_content": d.a.content.decode("utf-8", "replace"),
    }


def build_app(config: Config | None = None) -> App:
    app = new(config=config or DefaultsConfig(DEFAULTS))
    app.post("/upload", upload_handler)
    return app


if __name__ == "__main__":
    build_app().run()
