"""CLI apps (counterpart of gofr_tpu/cmd.py): ``new_cmd()`` builds a
``CMDApp``, an App without servers whose ``run(argv)`` joins the non-flag
words into a command, matches it against the registered sub-command
patterns (the user's first, then the built-ins ``profile`` and
``replay``) and calls the handler with the same Context HTTP handlers
get. ``-k=v`` / ``--k=v`` flags are params, a bare ``-flag`` is
``"true"``; ``ctx.bind(Dataclass)`` coerces them. A result prints to
stdout (exit 0), an exception's text to stderr (exit 1); no command or
``help`` prints the command list, an unknown one prints it to stderr
(exit 1)."""

from __future__ import annotations

import dataclasses
import re
import sys
from typing import Any, Callable, get_type_hints

from .config import Config, EnvConfig
from .container import Container
from .context import Context


class CMDRequest:
    """Parses argv: non-flag words form the command; -k=v / --k=v / -flag
    become params (cmd/request.go:25-117)."""

    def __init__(self, argv: list[str]):
        self.params: dict[str, str] = {}
        words: list[str] = []
        for arg in argv:
            if arg.startswith("-"):
                key = arg.lstrip("-")
                if "=" in key:
                    k, _, v = key.partition("=")
                    self.params[k] = v
                elif key:
                    self.params[key] = "true"
            else:
                words.append(arg)
        self.command = " ".join(words)
        self.context: dict[str, Any] = {}

    def param(self, key: str) -> str:
        return self.params.get(key, "")

    def params_list(self, key: str) -> list[str]:
        v = self.params.get(key)
        return [v] if v is not None else []

    # Context delegation surface
    def path_param(self, key: str) -> str:
        return self.params.get(key, "")

    def header(self, _key: str) -> str:
        return ""

    def host_name(self) -> str:
        return ""

    def bind(self, target: Any = None) -> Any:
        """Bind flags onto a dataclass by field name (cmd Bind analogue)."""
        if target is None:
            return dict(self.params)
        if dataclasses.is_dataclass(target):
            hints = get_type_hints(target)
            kwargs = {}
            for f in dataclasses.fields(target):
                if f.name in self.params:
                    v: Any = self.params[f.name]
                    t = hints.get(f.name, str)
                    if t is int:
                        v = int(v)
                    elif t is float:
                        v = float(v)
                    elif t is bool:
                        v = str(v).lower() in ("1", "true", "yes", "on")
                    kwargs[f.name] = v
            return target(**kwargs)
        raise TypeError("bind target must be a dataclass or None")


def profile_command(ctx: Context) -> str:
    """Built-in ``profile``: one ``torch.profiler`` capture window
    (``profiling.capture``), reporting where the trace landed. Flags:
    -seconds=N (default 2, clamped 0.1..30), -dir=PATH (the trace
    directory; default GOFR_PROFILE_DIR or the temporary directory),
    -out=FILE.zip (also write the zipped archive there)."""
    from .profiling.capture import profiler_capture

    seconds = float(ctx.param("seconds") or 2.0)
    trace_dir = ctx.param("dir") or None
    res = profiler_capture().capture(seconds, budget_s=max(60.0, seconds + 30.0), trace_dir=trace_dir)
    out = ctx.param("out")
    if out:
        with open(out, "wb") as f:
            f.write(res["archive"])
    parked = f" (parked: {res['parked']})" if res.get("parked") else ""
    return (
        f"profile mode={res['mode']}{parked} seconds={res['seconds']} "
        f"files={len(res['files'])} dir={res['dir']}"
        + (f" archive={out}" if out else "")
    )


def replay_command(ctx: Context) -> str:
    """Built-in ``replay``: the flight recorder's CLI face (``flightrec``).

    ``replay -id=N`` POSTs the serving process's loopback-only
    /.well-known/debug/replay route — the engine re-executes flight
    record N with pinned version/adapter/grammar/seed and reports the
    first-divergence token index vs the recorded emission. Flags:
    -id=N (required), -url=http://127.0.0.1:9100 (default), -model=NAME
    (searches all models when omitted), -timeout=SECONDS (default 120).

    ``replay -bundle=DIR`` instead lists the flight records inside a
    black-box bundle directory on disk — the "which id do I replay"
    step of the incident runbook."""
    import json as _json
    import os as _os_mod
    import urllib.request

    bundle = ctx.param("bundle")
    if bundle:
        path = _os_mod.path.join(bundle, "flight_records.json")
        with open(path) as f:
            records = _json.load(f)
        lines = [f"{len(records)} flight record(s) in {bundle}:"]
        for r in records:
            lines.append(
                f"  id={r.get('id')} model={r.get('model')}"
                f"@{r.get('model_version')} "
                f"prompt={r.get('prompt_len')} "
                f"emitted={r.get('emitted_len')} "
                f"finish={r.get('finish_reason')} "
                f"{'final' if r.get('final') else 'IN-FLIGHT'}"
                f"{' redacted' if r.get('redacted') else ''}"
            )
        return "\n".join(lines)
    rid = ctx.param("id")
    if not rid:
        raise ValueError("replay needs -id=N (or -bundle=DIR to list one)")
    url = ctx.param("url") or "http://127.0.0.1:9100"
    body: dict[str, Any] = {"id": int(rid)}
    if ctx.param("model"):
        body["model"] = ctx.param("model")
    timeout = float(ctx.param("timeout") or 120.0)
    body["timeout"] = timeout
    req = urllib.request.Request(
        f"{url}/.well-known/debug/replay",
        data=_json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout + 30.0) as resp:
        out = _json.loads(resp.read())
    data = out.get("data", out) if isinstance(out, dict) else {}
    rep = data.get("replay", {})
    if rep.get("error"):
        raise ValueError(f"replay failed: {rep['error']}")
    div = rep.get("first_divergence")
    verdict = (
        "token-identical" if rep.get("match")
        else f"DIVERGED at token index {div}"
    )
    return (
        f"replay id={rep.get('id')} model={data.get('model')}"
        f"@{rep.get('model_version')} {verdict} "
        f"(recorded {rep.get('recorded_len')} tokens, replayed "
        f"{rep.get('replayed_len')}, {rep.get('replay_ms')} ms)"
    )


class CMDApp:
    """App without servers; run() dispatches one subcommand."""

    def __init__(self, config: Config | None = None, configs_dir: str = "./configs"):
        self.config = config if config is not None else EnvConfig(configs_dir)
        self.container = Container.create(self.config)
        self.logger = self.container.logger
        self._routes: list[tuple[re.Pattern, Callable, str]] = []
        # Built-in subcommands, dispatched after the user's and anchored
        # with \Z, so neither a user's own `profile` command nor a
        # `profile-export`-style name is taken by a built-in.
        self._builtins: list[tuple[re.Pattern, Callable, str]] = [(
            re.compile(r"profile\Z"),
            profile_command,
            "capture a device profile (-seconds=N -dir=PATH -out=FILE.zip)",
        ), (
            re.compile(r"replay\Z"),
            replay_command,
            "deterministically replay a flight record "
            "(-id=N [-url=... -model=... -timeout=S] | -bundle=DIR)",
        )]

    def sub_command(self, pattern: str, handler: Callable, description: str = "") -> None:
        """Register a subcommand; pattern is a regex matched against the
        joined non-flag args (gofr.go:277, cmd.go:56-65)."""
        self._routes.append((re.compile(pattern), handler, description))

    # alias matching the reference's SubCommand naming
    add_sub_command = sub_command

    def _help_text(self) -> str:
        lines = ["Available commands:"]
        for pat, _, desc in self._routes + self._builtins:
            lines.append(f"  {pat.pattern}  {('- ' + desc) if desc else ''}")
        return "\n".join(lines)

    def run(self, argv: list[str] | None = None) -> int:
        argv = argv if argv is not None else sys.argv[1:]
        req = CMDRequest(argv)
        if not req.command or req.command in ("help", "--help"):
            print(self._help_text())
            return 0
        for pattern, handler, _desc in self._routes + self._builtins:
            if pattern.fullmatch(req.command) or pattern.match(req.command):
                ctx = Context(req, self.container)
                try:
                    result = handler(ctx)
                except Exception as e:  # noqa: BLE001 - CLI error boundary
                    print(str(e) or e.__class__.__name__, file=sys.stderr)
                    return 1
                if result is not None:
                    print(result)
                return 0
        print(f"No Command Found! {req.command!r}", file=sys.stderr)
        print(self._help_text(), file=sys.stderr)
        return 1
