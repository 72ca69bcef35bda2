"""The port's API listing (``sdr_tpu_torch/gen_api.py`` ->
``sdr_tpu_torch/API.md``): it names every symbol of every ``__all__`` in
the port under its module, the committed file is a fresh run's, and
generating it imports neither ``jax`` nor anything of ``sdr_tpu``."""

import importlib
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

import sdr_tpu_torch
from sdr_tpu_torch import gen_api

ROOT = Path(sdr_tpu_torch.__file__).resolve().parent.parent


def _sections(text):
    """{module: [symbols]} of the listing's tables."""
    out, current = {}, None
    for line in text.splitlines():
        m = re.match(r"#{2,3} `([\w.]+)`", line)
        if m:
            current = out.setdefault(m.group(1), [])
        m = re.match(r"\| `(\w+)` \((class|fn|module|const)\) \|", line)
        if m:
            current.append(m.group(1))
    return out


def _modules_with_all():
    names = ["sdr_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(sdr_tpu_torch.__path__,
                                              "sdr_tpu_torch.")]
    for name in names:
        mod = importlib.import_module(name)
        if getattr(mod, "__all__", None) is not None:
            yield mod


@pytest.fixture(scope="module")
def listing():
    return gen_api.render()


def test_every_all_name_is_listed_under_its_module(listing):
    sections = _sections(listing)
    mods = list(_modules_with_all())
    assert len(mods) > 40
    for mod in mods:
        assert mod.__name__ in sections, mod.__name__
        assert sorted(mod.__all__) == sections[mod.__name__], mod.__name__
    # each section package's own exports too
    for name, _ in gen_api.SECTIONS:
        assert sections[name], name
    assert "fir_strided" in sections["sdr_tpu_torch.kernels.fir"]
    assert "complex_layout" in sections["sdr_tpu_torch.kernels.fir"]


def test_committed_listing_is_a_fresh_run(listing):
    assert gen_api.LISTING == ROOT / "sdr_tpu_torch" / "API.md"
    assert gen_api.LISTING.read_text() == listing, (
        "sdr_tpu_torch/API.md is stale: python -m sdr_tpu_torch.gen_api")
    assert gen_api.main(["--check"]) == 0
    # the JAX package's listing stays its own
    assert "sdr_tpu_torch" not in (ROOT / "docs" / "API.md").read_text()


def test_generating_imports_no_jax(tmp_path):
    code = ("import sys\n"
            "from sdr_tpu_torch import gen_api\n"
            "text = gen_api.render()\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'sdr_tpu')]\n"
            "assert not bad, bad\n"
            "sys.stdout.write(text)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, check=True, timeout=120,
                         capture_output=True, text=True).stdout
    assert out == gen_api.LISTING.read_text()
    rc = subprocess.run([sys.executable, "-m", "sdr_tpu_torch.gen_api",
                         "--check"], cwd=tmp_path, env=env, timeout=120)
    assert rc.returncode == 0
