"""Regenerate the port's API listing, ``sdr_tpu_torch/API.md``: one line
per public symbol (the counterpart of the JAX package's
``tools/gen_api.py``, whose ``docs/API.md`` lists ``sdr_tpu``).

    python -m sdr_tpu_torch.gen_api            # writes sdr_tpu_torch/API.md
    python -m sdr_tpu_torch.gen_api --check    # exit 1 where it is stale

Each section lists a package's public names (its ``__all__``, or the
names it exports), then each of its modules that declares ``__all__``,
name by name, with the first line of each docstring.  Every module of a
section is imported first, so the listing does not depend on what was
imported before.  It imports the port alone (no ``jax``, nothing of
``sdr_tpu``) and runs on the CPU: importing a kernel module builds
nothing.
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import pkgutil
import sys
from pathlib import Path

__all__ = ["SECTIONS", "LISTING", "render", "main"]

SECTIONS = [
    ("sdr_tpu_torch", "The package's exports"),
    ("sdr_tpu_torch.ops", "DSP ops (plain PyTorch, and the kernels' "
                          "callers)"),
    ("sdr_tpu_torch.stream", "Streaming operators and pipelines"),
    ("sdr_tpu_torch.parallel", "Block-parallel and sharded execution over "
                               "torch.distributed"),
    ("sdr_tpu_torch.io", "Host I/O sources and sinks"),
    ("sdr_tpu_torch.apps.chains", "Canonical receive chains (BASELINE "
                                  "configs)"),
    ("sdr_tpu_torch.utils", "Device, profiling, roofline, args"),
    ("sdr_tpu_torch.kernels", "Hand-written CUDA kernels for Hopper "
                              "(K1-K13)"),
]
LISTING = Path(__file__).resolve().parent / "API.md"
_PRIMITIVE = (bool, int, float, str)


def _modules(mod) -> list:
    """The section's own module, then (for a package) each module
    directly inside it, all imported."""
    out = [mod]
    if hasattr(mod, "__path__"):
        for info in sorted(pkgutil.iter_modules(mod.__path__),
                           key=lambda i: i.name):
            if not info.ispkg:
                out.append(importlib.import_module(
                    f"{mod.__name__}.{info.name}"))
    return out


def _public(mod) -> list:
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in dir(mod) if not n.startswith("_")
                 and not (inspect.ismodule(getattr(mod, n))
                          and not getattr(mod, n).__name__.startswith(
                              "sdr_tpu_torch"))]
    return sorted(names)


def _kind(obj) -> str:
    if inspect.ismodule(obj):
        return "module"
    if inspect.isclass(obj):
        return "class"
    return "fn" if callable(obj) else "const"


def _summary(obj) -> str:
    """A docstring's first line; for a constant its value where it is
    short and primitive, else its type (never an address or a path)."""
    if _kind(obj) != "const":
        doc = inspect.getdoc(obj) or ""
        line = doc.splitlines()[0] if doc else ""
    elif isinstance(obj, _PRIMITIVE) or (
            isinstance(obj, (tuple, list))
            and all(isinstance(v, _PRIMITIVE) for v in obj)):
        line = repr(obj)
        if len(line) > 72:
            line = f"{type(obj).__name__} of {len(obj)}"
    else:
        line = type(obj).__name__
        if isinstance(obj, (tuple, list, dict)):
            line += f" of {len(obj)}"
    return line.replace("|", "\\|")


def _table(mod, names) -> list:
    lines = ["| symbol | summary |", "|---|---|"]
    for n in names:
        obj = getattr(mod, n, None)
        if obj is None:
            continue
        lines.append(f"| `{n}` ({_kind(obj)}) | {_summary(obj)} |")
    return lines


def render() -> str:
    """The listing, as ``API.md`` holds it."""
    mods = [(importlib.import_module(name), title) for name, title
            in SECTIONS]
    walked = [(mod, title, _modules(mod)) for mod, title in mods]
    out = ["# sdr_tpu_torch public API", "",
           "One line per public symbol (a module's `__all__`, or the "
           "names a package",
           "exports); see the docstrings for the full contracts.  "
           "Regenerate with",
           "`python -m sdr_tpu_torch.gen_api`.  The JAX package's "
           "listing is `docs/API.md`.", ""]
    for mod, title, modules in walked:
        out += [f"## `{mod.__name__}` — {title}", ""]
        out += _table(mod, _public(mod)) + [""]
        for sub in modules[1:]:
            if getattr(sub, "__all__", None) is not None:
                out += [f"### `{sub.__name__}`", ""]
                out += _table(sub, _public(sub)) + [""]
    return "\n".join(out)


def main(argv=None) -> int:
    """Write ``API.md`` (``--check``: compare with a fresh run instead)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="exit 1 where API.md differs from a fresh run")
    args = ap.parse_args(argv)
    text = render()
    if args.check:
        stale = not LISTING.exists() or LISTING.read_text() != text
        if stale:
            print(f"{LISTING} is stale: python -m sdr_tpu_torch.gen_api",
                  file=sys.stderr)
        return int(stale)
    LISTING.write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
