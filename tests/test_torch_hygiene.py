"""Import hygiene of the port: ``repro_torch`` and ``chip_smoke.py`` import
neither jax nor anything of the JAX package ``repro``, a real serve runs with
jax blocked, and the entry points never fall back to the CPU on their own."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_or_repro_imports():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 30
    bad = []
    for f in files:
        for mod in _imported_modules(f):
            root = mod.split(".")[0]
            if root in ("jax", "jaxlib", "repro", "ml_dtypes"):
                bad.append(f"{f.relative_to(REPO)}: {mod}")
    assert not bad, bad


_SERVE_WITHOUT_JAX = r"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
from repro_torch.configs import get_smoke_config
from repro_torch.data.datasets import make_dataset
from repro_torch.data.trace import TraceConfig, build_trace
from repro_torch.engine.tokenizer import HashTokenizer
from repro_torch.serving import build_real_engine
cfg = get_smoke_config("qwen3-1.7b")
tok = HashTokenizer(vocab_size=cfg.vocab_size - 2)
trace = build_trace(make_dataset("rotten", num_rows=64, seed=0),
                    TraceConfig(num_relqueries=2, rate=10.0, seed=0,
                                max_requests=2, output_token_cap=3),
                    tokenizer=tok)
engine = build_real_engine("qwen3-1.7b", "relserve", "paged", device="cpu")
report = engine.run_trace(trace)
assert len(report.latencies) == 2
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
print("SERVED", sum(len(r.output_tokens) for rq in trace for r in rq.requests))
"""


def test_serves_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", _SERVE_WITHOUT_JAX], env=env,
                         capture_output=True, text=True, timeout=240,
                         cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    assert "SERVED" in out.stdout


def test_no_device_and_no_card_raises(monkeypatch):
    from repro_torch.serving import build_real_engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_real_engine()
