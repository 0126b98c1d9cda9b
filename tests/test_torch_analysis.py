"""The port's contract linter (``repro_torch.analysis``), on snippets in a
scratch repo under ``tmp_path`` (never under the repo's ``src/``, which
the reference linter reads):

- each rule fires on its violating snippet, stays silent on the fixed
  one, and is silenced by a justified ``# repro_torch: noqa[ID] -- why``;
- a bare noqa does not suppress (TANA002), an unused one is reported
  (TANA001), a noqa naming an unknown id is reported, and the reference's
  ``# repro:`` marker is not this linter's;
- the rule scopes (serving, the named device-only functions, the
  order-sensitive files, ``core/``), ``__all__`` built as the port's
  ``__init__`` files build it, and every named device-only function
  existing in the tree;
- the baseline round trip, the CLI's exit codes and JSON;
- the linter's modules import only the standard library and each other
  (by AST), and ``python -m repro_torch.analysis --check`` is clean on
  this tree.
"""
import ast
import json
import pathlib
import subprocess
import sys
import textwrap

import pytest

from repro_torch.analysis import (RULES, apply_baseline, load_baseline,
                                  run_analysis, write_baseline)
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.analysis.framework import functions
from repro_torch.analysis.rules.sync import DEVICE_ONLY

ROOT = pathlib.Path(__file__).resolve().parent.parent
MOD = "src/repro_torch/nn/mod.py"
SERVING = "src/repro_torch/serving/mod.py"
INFER = "src/repro_torch/core/infer.py"
CACHE = "src/repro_torch/serving/cache.py"
CORE = "src/repro_torch/core/mod.py"
INIT = "src/repro_torch/pkg/__init__.py"


def _run(tmp_path, code, rel=MOD, extra=None):
    """Analyze one snippet placed at ``rel`` in a scratch repo."""
    root = tmp_path / "repo"
    for relp, content in {rel: code, **(extra or {})}.items():
        p = root / relp
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(content))
    return run_analysis(root, files=[rel])


def _fired(result):
    return {f.rule for f in result.findings}


# rule -> (path, violating snippet, clean snippet); the violating line is
# the last line of its snippet, where the suppression test appends a noqa
FIXTURES = {
    "TRNG001": (MOD, "import torch\ntorch.manual_seed(0)\n",
                "import torch\ng = torch.Generator().manual_seed(0)\n"),
    "TRNG002": (
        MOD, "import torch\nx = torch.randn(\n    (3, 4),\n    dtype="
             "torch.float32)\n",
        "import torch\ng = torch.Generator().manual_seed(0)\n"
        "x = torch.randn(\n    (3, 4),\n    generator=g,\n)\n"
        "torch.nn.init.normal_(x, generator=g)\nx.uniform_(generator=g)\n"
        "torch.nn.init.zeros_(x)\n"),
    "TRNG003": (MOD, "import torch\ng = torch.Generator(device='cpu')\n",
                "import torch\nseed = 3\n"
                "g = torch.Generator(device='cpu').manual_seed(seed)\n"),
    "TRNG004": (MOD, "import time, torch\n"
                     "g = torch.Generator().manual_seed(int(time.time()))\n",
                "import torch\ng = torch.Generator().manual_seed(7)\n"),
    "TSYNC001": (SERVING, "def f(x):\n    return x.max().item()\n",
                 "def f(x):\n    return x.max().cpu().numpy()\n"),
    "TSYNC002": (SERVING, "import torch\ndef f(x):\n"
                          "    return float(torch.max(x))\n",
                 "import numpy as np\ndef f(x):\n"
                 "    return float(np.max(x))\n"),
    "TSYNC003": (INFER, "def _guard(consts, carry, a, hw, rounds: int):\n"
                        "    return int(a.max())\n",
                 "SYNC = -1\ndef _guard(consts, carry, a, hw, rounds: int):\n"
                 "    return a.shape[0] + int(rounds) + float(SYNC)\n"),
    "TSYNC004": (INFER, "def _guard(consts, carry, a, hw, rounds: int):\n"
                        "    if (a > 1).any():\n        a = a // 2\n"
                        "    return a\n",
                 "import torch\n"
                 "def _guard(consts, carry, a, hw, rounds: int):\n"
                 "    if hw is None or rounds > 2 or isinstance(a, int):\n"
                 "        return a\n"
                 "    return torch.where(a > 1, a // 2, a)\n"),
    "TDET001": (CACHE, "def keys(d):\n    return [k for k in set(d)]\n",
                "def keys(d):\n    return [k for k in sorted(set(d))]\n"),
    "TDET002": (CORE, "import torch\nx = torch.zeros(3, dtype=torch.float64)\n",
                "import torch\nx = torch.zeros(3, dtype=torch.float32)\n"),
    "TDET003": (MOD, "def g(out, idx, src):\n"
                     "    return out.index_put_((idx,), src, accumulate=True)\n",
                "def g(out, idx, src):\n"
                "    return out.index_put_((idx,), src, accumulate=False)\n"),
    "TEXP001": (INIT, "__all__ = ['a', 'b']\na = 1\n",
                "__all__ = ['a', 'b']\na = 1\nb = 2\n"),
    "TEXP002": (INIT, "_T = {'x': 'm'}\n__all__ = ['a']\na = 1\n"
                      "def __getattr__(name):\n    if name in _T:\n"
                      "        return name\n    raise AttributeError(name)\n",
                "_T = {'x': 'm'}\n__all__ = ['a'] + sorted(_T)\na = 1\n"
                "def __getattr__(name):\n    if name in _T:\n"
                "        return name\n    raise AttributeError(name)\n"),
    "TJIT001": (MOD, "import functools\n@functools.lru_cache(maxsize=8)\n"
                     "def plan(accel, n):\n    return n\n",
                "import functools\n@functools.lru_cache(maxsize=8)\n"
                "def plan(rows, n):\n    return n\n"),
}
# the line each violation is reported on, where it differs from the last
_LINE = {"TRNG002": 2, "TSYNC004": 2, "TEXP001": 1, "TEXP002": 2,
         "TJIT001": 3}


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_rule_fires_on_violation(tmp_path, rule):
    rel, bad, _ = FIXTURES[rule]
    assert rule in _fired(_run(tmp_path, bad, rel)), rule


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_rule_silent_on_clean(tmp_path, rule):
    rel, _, good = FIXTURES[rule]
    res = _run(tmp_path, good, rel)
    assert not res.findings, [f.format() for f in res.findings]


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_rule_suppressed_with_justified_noqa(tmp_path, rule):
    rel, bad, _ = FIXTURES[rule]
    lines = bad.rstrip("\n").split("\n")
    at = _LINE.get(rule, len(lines)) - 1
    lines[at] += f"  # repro_torch: noqa[{rule}] -- fixture"
    res = _run(tmp_path, "\n".join(lines) + "\n", rel)
    assert rule not in _fired(res) and not res.findings, \
        [f.format() for f in res.findings]
    assert rule in {f.rule for f in res.suppressed}


def test_every_rule_has_a_fixture_and_a_contract():
    meta = {"TANA001", "TANA002"}
    assert set(RULES) == set(FIXTURES) | meta
    assert all(r.contract and r.description for r in RULES.values())


def test_bare_noqa_does_not_suppress(tmp_path):
    res = _run(tmp_path, "import torch\n"
               "torch.manual_seed(0)  # repro_torch: noqa[TRNG001]\n")
    assert _fired(res) == {"TRNG001", "TANA002"}


def test_unknown_and_unused_noqa(tmp_path):
    res = _run(tmp_path, "x = 1  # repro_torch: noqa[TRNG001] -- stale\n"
               "y = 2  # repro_torch: noqa[TXYZ999] -- no such rule\n")
    assert [f.rule for f in res.findings] == ["TANA001", "TANA002"]


def test_the_reference_marker_is_not_this_linters(tmp_path):
    res = _run(tmp_path, "import torch\n"
               "torch.manual_seed(0)  # repro: noqa[TRNG001] -- other\n")
    assert _fired(res) == {"TRNG001"}


def test_noqa_inside_a_string_is_not_a_suppression(tmp_path):
    res = _run(tmp_path, 'DOC = """x  # repro_torch: noqa[TRNG001] -- no"""\n')
    assert not res.findings


def test_sync_scopes(tmp_path):
    """``.item()`` outside serving and a branch outside the named
    device-only functions are not this linter's business; a named
    function in another file is not named."""
    item = "def f(x):\n    return x.item()\n"
    assert not _run(tmp_path, item, MOD).findings
    branch = ("def _helper(a):\n    if a.any():\n        return a\n"
              "    return a\n")
    assert not _run(tmp_path, branch, INFER).findings
    guard = "def _guard(a):\n    return a.item()\n"
    assert not _run(tmp_path, guard, MOD).findings
    assert _fired(_run(tmp_path, guard, INFER)) == {"TSYNC003"}


def test_sync003_catches_each_host_copy(tmp_path):
    code = ("import torch\nclass DT:\n    def time_emb(self, idx):\n"
            "        a = idx.cpu()\n        b = idx.tolist()\n"
            "        c = idx.numpy()\n        torch.cuda.synchronize()\n"
            "        return bool(idx)\n")
    res = _run(tmp_path, code, "src/repro_torch/core/model.py")
    assert [f.line for f in res.findings] == [4, 5, 6, 7, 8]


def test_det_scopes(tmp_path):
    assert not _run(tmp_path, FIXTURES["TDET001"][1], MOD).findings
    assert not _run(tmp_path, FIXTURES["TDET002"][1], MOD).findings
    for call in ("x.index_add_(0, i, y)", "x.scatter_add_(0, i, y)",
                 "F.embedding(i, w)"):
        res = _run(tmp_path, f"def f(x, i, y, w, F):\n    return {call}\n")
        assert _fired(res) == {"TDET003"}, call


def test_exports_resolve_the_ports_forms(tmp_path):
    """``__all__`` from ``_PUBLIC`` (``repro_torch/__init__.py``), from a
    starred tuple (``core``), ``list(_HOME)`` (``launch``) and names of
    submodules (``kernels``)."""
    code = ("_PUBLIC = {'A': 'core'}\n_API = ('B',)\n_HOME = {'C': 'm'}\n"
            "__all__ = ['serve', *_API] + sorted(_PUBLIC) + list(_HOME)\n"
            "def serve():\n    pass\n"
            "def __getattr__(name):\n"
            "    if name in _PUBLIC or name in _API or name in _HOME:\n"
            "        return name\n    raise AttributeError(name)\n")
    assert not _run(tmp_path, code, INIT).findings
    sub = "__all__ = ['flash', 'ops']\n"
    res = _run(tmp_path, sub, INIT, {
        "src/repro_torch/pkg/flash.py": "x = 1\n",
        "src/repro_torch/pkg/ops/__init__.py": "y = 2\n"})
    assert not res.findings
    assert _fired(_run(tmp_path, "__all__ = [name for name in 'ab']\n",
                       INIT)) == {"TEXP001"}


def test_every_named_device_only_function_exists():
    for rel, names in DEVICE_ONLY.items():
        tree = ast.parse((ROOT / rel).read_text())
        have = {q for q, _ in functions(tree)}
        assert names <= have, (rel, sorted(names - have))


def test_baseline_round_trip(tmp_path):
    res = _run(tmp_path, "import torch\n\ntorch.manual_seed(0)\n")
    base = tmp_path / "base.json"
    entries = write_baseline(base, res.findings)
    assert entries[0]["justification"].startswith("GRANDFATHERED")
    assert load_baseline(base) == entries
    # the line moves: the fingerprint still absorbs it
    moved = _run(tmp_path, "import torch\n\n\n\ntorch.manual_seed(0)\n")
    new, stale = apply_baseline(moved.findings, entries)
    assert not new and not stale
    new, stale = apply_baseline([], entries)
    assert stale == entries
    entries[0]["justification"] = " "
    base.write_text(json.dumps({"version": 1, "entries": entries}))
    with pytest.raises(ValueError, match="justification"):
        load_baseline(base)


def test_cli_exit_codes_and_json(tmp_path, capsys):
    root = tmp_path / "repo"
    (root / "src/repro_torch").mkdir(parents=True)
    bad = root / "src/repro_torch/m.py"
    bad.write_text("import torch\ntorch.manual_seed(0)\n")
    out = tmp_path / "out.json"
    assert cli_main(["--root", str(root), "--check", "--json",
                     str(out)]) == 1
    payload = json.loads(out.read_text())
    assert [f["rule"] for f in payload["findings"]] == ["TRNG001"]
    assert cli_main(["--root", str(root)]) == 0       # report only
    base = tmp_path / "base.json"
    assert cli_main(["--root", str(root), "--write-baseline",
                     str(base)]) == 0
    assert cli_main(["--root", str(root), "--check", "--baseline",
                     str(base)]) == 0
    bad.write_text("x = 1\n")                          # the entry is stale
    assert cli_main(["--root", str(root), "--check", "--baseline",
                     str(base)]) == 1
    assert cli_main(["--root", str(tmp_path / "nowhere")]) == 2
    assert cli_main(["--list-rules"]) == 0
    assert "TRNG002" in capsys.readouterr().out


def test_linter_imports_only_the_stdlib_and_itself():
    pkg = ROOT / "src/repro_torch/analysis"
    files = sorted(pkg.rglob("*.py"))
    assert len(files) >= 11
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] in sys.stdlib_module_names \
                    or m == "__future__", (f, m)
            assert not any(m.startswith(("repro", "torch", "jax", "numpy"))
                           for m in mods), (f, mods)


def test_the_tree_is_clean():
    """``python -m repro_torch.analysis --check`` from the repo root, as a
    user runs it."""
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                        "--check"], cwd=ROOT, capture_output=True,
                       text=True, env={"PYTHONPATH": str(ROOT / "src"),
                                       "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stdout + r.stderr
    assert " 0 finding(s)" in r.stdout
