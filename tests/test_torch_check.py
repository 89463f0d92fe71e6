"""Tests for ``repro_torch.check``, the port's static contract linter.

Each rule has bad and clean fixtures under
``tests/torch_check/check_fixtures/`` (``.cu`` beside ``.py`` for the
rules that read CUDA); the bad ones assert exact rule ids and line
numbers (they are the rule's specification), the golden JSON pins the
full report, and the self-run is the gate: zero findings over the port,
its CUDA sources and its examples.  The rules restated for the port
(DET01, DET02, KRN01, SPMD01) read files with a ``repro_torch`` directory
in their path, so their fixtures sit under ``check_fixtures/repro_torch/``
and the mutation tests copy real sources to ``tmp_path/repro_torch/``.
The five framework-free rules give ``repro.check``'s findings on the JAX
package's own fixtures.
"""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from repro_torch.check import all_rules, iter_source_files, run_check
from repro_torch.check.registry import CudaModule, Module
from repro_torch.check.report import render_json

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "torch_check", "check_fixtures")
REFERENCE_FIXTURES = os.path.join(ROOT, "tests", "check_fixtures")
PORT = os.path.join(ROOT, "src", "repro_torch")
EXAMPLES = ["examples/policy_playground_torch.py",
            "examples/quickstart_torch.py",
            "examples/serve_guided_kv_torch.py",
            "examples/train_guided_offload_torch.py"]
CUDA_SOURCES = ["flash_attention.cu", "moe_gemm.cu", "paged_attention.cu",
                "ssd_scan.cu"]


def fixture(name):
    return os.path.join(FIXTURES, name)


def found(path, rule_ids=None):
    return [(f.rule, f.line) for f in run_check([path], rule_ids=rule_ids)]


# (rule id, [(bad fixture, expected finding lines)], [clean fixtures])
RULE_CASES = [
    ("CHK00", [("chk00_bad.py", [4, 6]), ("chk00_bad.cu", [4, 6])],
     ["chk00_clean.py", "chk00_clean.cu"]),
    ("DET01", [("repro_torch/det01_bad.py", [10, 11, 12, 13, 18, 23, 31]),
               ("repro_torch/det01_bad.cu", [5, 7])],
     ["repro_torch/det01_clean.py", "repro_torch/det01_clean.cu"]),
    ("DET02", [("repro_torch/det02_bad.py", [8, 9, 10, 11, 14, 19, 27, 33])],
     ["repro_torch/det02_clean.py"]),
    ("EXC01", [("exc01_bad.py", [7, 14])], ["exc01_clean.py"]),
    ("FT01", [("serve/ft01_bad.py", [11, 14, 17])], ["serve/ft01_clean.py"]),
    ("KRN01", [("repro_torch/krn01_bad.py", [21, 34, 40]),
               ("repro_torch/krn01_bad.cu", [9, 15, 22, 28, 29])],
     ["repro_torch/krn01_clean.py", "repro_torch/krn01_clean.cu"]),
    ("KV01", [("kv01_bad.py", [11, 16, 22])], ["kv01_clean.py"]),
    ("SCHED01", [("serve/sched01_bad.py", [13, 14, 15, 16, 21, 22, 23, 24])],
     ["serve/sched01_clean.py"]),
    ("SPMD01", [("repro_torch/spmd01_bad.py", [9, 14]),
                ("repro_torch/spmd01_bad/dist/collectives.py", [8, 20, 24])],
     ["repro_torch/spmd01_clean.py",
      "repro_torch/spmd01_clean/dist/collectives.py"]),
]
BAD = [(rule, path, lines) for rule, bads, _ in RULE_CASES
       for path, lines in bads]
CLEAN = [(rule, path) for rule, _, cleans in RULE_CASES for path in cleans]


def test_every_registered_rule_has_a_fixture_case():
    from repro.check import all_rules as reference_rules

    assert sorted(all_rules()) == sorted(r for r, _, _ in RULE_CASES)
    assert sorted(all_rules()) == sorted(reference_rules())


@pytest.mark.parametrize("rule,path,lines", BAD,
                         ids=[p for _, p, _ in BAD])
def test_bad_fixture_findings(rule, path, lines):
    assert found(fixture(path)) == [(rule, ln) for ln in lines]


@pytest.mark.parametrize("rule,path", CLEAN, ids=[p for _, p in CLEAN])
def test_clean_fixture_is_clean(rule, path):
    assert found(fixture(path)) == []


def test_golden_json(monkeypatch):
    monkeypatch.chdir(ROOT)
    findings = run_check(["tests/torch_check/check_fixtures"])
    report = json.loads(render_json(
        findings, {rid: r.title for rid, r in all_rules().items()}))
    with open(fixture("golden.json"), encoding="utf-8") as f:
        golden = json.load(f)
    assert report == golden


def test_self_run_is_clean(monkeypatch):
    """The gate: zero findings over the port, its CUDA sources and its
    examples."""
    monkeypatch.chdir(ROOT)
    assert all(os.path.isfile(p) for p in EXAMPLES)
    findings = run_check(["src/repro_torch"] + EXAMPLES)
    assert findings == [], "\n".join(
        f"{f.location()}: {f.rule} {f.message}" for f in findings)


def test_self_run_reads_the_cuda_sources(monkeypatch):
    monkeypatch.chdir(ROOT)
    walked = iter_source_files(["src/repro_torch"])
    cu = sorted(os.path.basename(p) for p in walked if p.endswith(".cu"))
    assert cu == CUDA_SOURCES
    assert not any(f"{os.sep}build{os.sep}" in p for p in walked)
    # Every extern "C" entry of the four sources is a function the lexer
    # classifies (KRN01 reads its return type), and every launch sits in
    # a function body (KRN01 follows it to its cudaGetLastError()).
    entries, launches = [], 0
    for name in CUDA_SOURCES:
        m = CudaModule.load(name, open(os.path.join(
            PORT, "kernels", "csrc", name), encoding="utf-8").read())
        for b in m.blocks:
            parent = m.blocks[b.parent] if b.parent is not None else None
            if b.kind == "function" and parent and \
                    parent.kind == "extern_c":
                entries.append(re.search(r"(\w+)\s*\(", b.header).group(1))
        for hit in re.finditer("<<<", m.code):
            assert m.innermost(hit.start(), ("function",)) is not None
            launches += 1
    assert sorted(entries) == sorted([
        "flash_attention_fwd_launch", "flash_attention_bwd_launch",
        "moe_grouped_ffn_launch", "moe_grouped_ffn_bwd_launch",
        "paged_attention_launch", "ssd_scan_launch", "ssd_scan_bwd_launch"])
    assert launches == 25


@pytest.mark.parametrize("path", ["serve/api.py", "train/trainer.py",
                                  "launch/analysis.py"])
def test_sanctioned_sites_are_clean(path):
    """``LLM.from_arch`` and ``Trainer`` seed one generator and thread it;
    the cost walk names the scatters in a string set: no finding."""
    assert run_check([os.path.join(PORT, path)],
                     rule_ids=["DET01", "DET02"]) == []


def test_fixtures_and_build_dirs_excluded_from_traversal(tmp_path):
    (tmp_path / "check_fixtures").mkdir()
    (tmp_path / "check_fixtures" / "bad.py").write_text("x = 1\n")
    (tmp_path / "build").mkdir()
    (tmp_path / "build" / "k.cu").write_text("int x;\n")
    (tmp_path / "ok.py").write_text("x = 1\n")
    (tmp_path / "k.cu").write_text("int x;\n")
    (tmp_path / "notes.txt").write_text("x\n")
    walked = iter_source_files([str(tmp_path)])
    assert walked == [str(tmp_path / "k.cu"), str(tmp_path / "ok.py")]
    # ...but explicit paths always win over the exclude list.
    explicit = str(tmp_path / "build" / "k.cu")
    assert iter_source_files([explicit]) == [explicit]


def test_rule_filter_and_unknown_rule():
    assert found(fixture("repro_torch/det01_bad.py"),
                 rule_ids=["EXC01"]) == []
    assert found(fixture("repro_torch/krn01_bad.cu"),
                 rule_ids=["DET01"]) == []
    with pytest.raises(ValueError, match="NOPE"):
        run_check([fixture("repro_torch/det01_bad.py")], rule_ids=["NOPE"])


@pytest.mark.parametrize("name,src,line", [
    ("broken.py", "def f(:\n", 1),
    ("comment.cu", "int x;\n/* never closed\n", 2),
    ("braces.cu", "int f() {\n  return 0;\n", 1),
    ("parens.cu", "int f() {\n  return g(1;\n}\n", 2),
    ("literal.cu", 'const char* s = "open;\n', 1),
])
def test_unparsable_file_reports_chk00(tmp_path, name, src, line):
    bad = tmp_path / name
    bad.write_text(src)
    got = run_check([str(bad)])
    assert [(f.rule, f.path, f.line) for f in got] == [
        ("CHK00", str(bad), line)]
    assert "does not parse" in got[0].message


def test_suppression_silences_only_named_rule():
    src = (
        "def probe(fn):\n"
        "    try:\n"
        "        fn()\n"
        "    # check: disable=KV01 -- wrong rule on purpose\n"
        "    except Exception:\n"
        "        return None\n"
    )
    m = Module.load("inline.py", src)
    exc01 = all_rules()["EXC01"]
    findings = [f for f in exc01.check(m) if not m.suppressed(f)]
    assert [(f.rule, f.line) for f in findings] == [("EXC01", 5)]


def test_cuda_suppression_silences_only_named_rule(tmp_path):
    src = (
        "__global__ void k(float* out, float v) {\n"
        "  // check: disable=KRN01 -- wrong rule on purpose\n"
        "  atomicAdd(out, v);\n"
        "  atomicAdd(out, v);  // check: disable=DET01 -- fixture\n"
        "  // check: disable=DET01 -- binds to the next code line\n"
        "\n"
        "  // a plain comment in between\n"
        "  atomicAdd(out, v);\n"
        "}\n"
    )
    path = tmp_path / "repro_torch" / "k.cu"
    path.parent.mkdir()
    path.write_text(src)
    assert found(str(path)) == [("DET01", 3)]


def test_cuda_lexer_keeps_offsets_and_lines():
    src = ('int a; /* one\n two */ const char* s = "x{\\"}";\n'
           "// c {\n#define M(x) { x }\nint f() { return '}'; }\n")
    m = CudaModule.load("x.cu", src)
    assert len(m.code) == len(src)
    assert m.code.count("\n") == src.count("\n")
    assert [b.kind for b in m.blocks] == ["function"]
    assert m.line_col(src.index("int f")) == (5, 1)


def test_cli_exit_code_json_and_rules(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    out = tmp_path / "report.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.check",
         fixture("repro_torch/krn01_bad.cu"), fixture("exc01_bad.py"),
         "--format", "json", "--output", str(out)],
        capture_output=True, text=True, env=env, cwd=ROOT)
    assert proc.returncode == 7          # exit code == finding count
    report = json.loads(out.read_text())
    assert report["count"] == 7
    assert {f["rule"] for f in report["findings"]} == {"EXC01", "KRN01"}
    assert set(report["rules"]) == set(all_rules())

    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.check",
         fixture("repro_torch/krn01_bad.cu"), fixture("exc01_bad.py"),
         "--rules", "EXC01"],
        capture_output=True, text=True, env=env, cwd=ROOT)
    assert proc.returncode == 2
    assert proc.stdout.rstrip().endswith("2 findings")

    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.check", "--list-rules"],
        capture_output=True, text=True, env=env, cwd=ROOT)
    assert proc.returncode == 0
    for rid in all_rules():
        assert rid in proc.stdout

    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.check", "src/repro_torch"]
        + EXAMPLES, capture_output=True, text=True, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout
    assert proc.stdout.strip() == "0 findings"


@pytest.mark.parametrize("rule", ["CHK00", "EXC01", "FT01", "SCHED01",
                                  "KV01"])
def test_parity_with_reference_on_its_fixtures(rule):
    """The framework-free rules give ``repro.check``'s (path, line) lists
    on the JAX package's own fixtures."""
    from repro.check import run_check as reference_check

    ours = [(f.path, f.line, f.rule)
            for f in run_check([REFERENCE_FIXTURES], rule_ids=[rule])]
    theirs = [(f.path, f.line, f.rule)
              for f in reference_check([REFERENCE_FIXTURES],
                                       rule_ids=[rule])]
    assert ours == theirs
    assert ours, f"{rule} found nothing on the reference fixtures"


# --------------------------------------------------------------- mutations
def _copy(tmp_path, rel):
    """A copy of the port's ``rel`` under ``tmp_path/repro_torch``."""
    dst = tmp_path / "repro_torch" / rel
    dst.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy(os.path.join(PORT, rel), dst)
    return dst


def _mutate(path, old, new, count=1):
    text = path.read_text(encoding="utf-8")
    assert text.count(old) == count, (old, text.count(old))
    path.write_text(text.replace(old, new, 1), encoding="utf-8")


def _insert_after(path, anchor, line):
    text = path.read_text(encoding="utf-8")
    assert text.count(anchor) == 1
    i = text.index(anchor) + len(anchor)
    path.write_text(text[:i] + "\n" + line + text[i:], encoding="utf-8")


def _lineno(path, needle):
    lines = path.read_text(encoding="utf-8").splitlines()
    hits = [i + 1 for i, s in enumerate(lines) if needle in s]
    assert len(hits) == 1, (needle, hits)
    return hits[0]


def test_mutation_drop_paged_error_check(tmp_path):
    """The cudaGetLastError() after paged_attention.cu's tensor-core
    launch, deleted: one KRN01 finding, on that launch."""
    cu = _copy(tmp_path, "kernels/csrc/paged_attention.cu")
    assert found(str(cu)) == []
    launch = _lineno(cu, "paged_attention_mma<DH><<<grid")
    text = cu.read_text(encoding="utf-8")
    at = text.index("paged_attention_mma<DH><<<grid")
    ret = text.index("  return cudaGetLastError();\n", at)
    cu.write_text(text[:ret] + "  return cudaSuccess;\n"
                  + text[ret + len("  return cudaGetLastError();\n"):],
                  encoding="utf-8")
    assert found(str(cu)) == [("KRN01", launch)]


def test_mutation_drop_launch_count(tmp_path):
    py = _copy(tmp_path, "kernels/paged_attention.py")
    assert found(str(py)) == []
    _mutate(py, '    LAUNCHES["paged_attention"] += 1\n', "")
    got = run_check([str(py)])
    assert [(f.rule, f.line) for f in got] == [
        ("KRN01", _lineno(py, "def paged_attention_cuda("))]
    assert "paged_attention_cuda" in got[0].message


def test_mutation_index_add_in_moe(tmp_path):
    py = _copy(tmp_path, "models/moe.py")
    assert found(str(py)) == []
    anchor = "def _sum_picks(rows: torch.Tensor, where: torch.Tensor)"
    text = py.read_text(encoding="utf-8")
    body = text.index('"""', text.index(anchor))
    end = text.index('"""', body + 3) + 3
    py.write_text(text[:end] + "\n    rows.index_add_(0, where, rows)"
                  + text[end:], encoding="utf-8")
    assert found(str(py)) == [
        ("DET01", _lineno(py, "rows.index_add_(0, where, rows)"))]


def test_mutation_randn_without_generator(tmp_path):
    py = _copy(tmp_path, "models/moe.py")
    anchor = "def _sum_picks(rows: torch.Tensor, where: torch.Tensor)"
    text = py.read_text(encoding="utf-8")
    body = text.index('"""', text.index(anchor))
    end = text.index('"""', body + 3) + 3
    py.write_text(text[:end] + "\n    noise = torch.randn(rows.shape)"
                  + text[end:], encoding="utf-8")
    assert found(str(py)) == [
        ("DET02", _lineno(py, "noise = torch.randn(rows.shape)"))]


def test_mutation_raw_all_reduce_outside_collectives(tmp_path):
    py = _copy(tmp_path, "models/moe.py")
    anchor = "def _sum_picks(rows: torch.Tensor, where: torch.Tensor)"
    text = py.read_text(encoding="utf-8")
    body = text.index('"""', text.index(anchor))
    end = text.index('"""', body + 3) + 3
    py.write_text(text[:end] + "\n    dist.all_reduce(rows)"
                  + text[end:], encoding="utf-8")
    assert found(str(py)) == [
        ("SPMD01", _lineno(py, "dist.all_reduce(rows)"))]
    # Inside dist/collectives.py the same call is allowed, but must name
    # its group.
    coll = _copy(tmp_path, "dist/collectives.py")
    assert found(str(coll)) == []
    _mutate(coll, "dist.all_reduce(t, group=group)", "dist.all_reduce(t)")
    assert found(str(coll)) == [
        ("SPMD01", _lineno(coll, "dist.all_reduce(t)"))]


def test_mutation_ring_peer_without_modulo(tmp_path):
    coll = _copy(tmp_path, "dist/collectives.py")
    _mutate(coll, "reqs = _hop(acc, (idx + 1) % n, nxt, (idx - 1) % n, "
                  "group)",
            "reqs = _hop(acc, idx + 1, nxt, (idx - 1) % n, group)")
    assert found(str(coll)) == [
        ("SPMD01", _lineno(coll, "reqs = _hop(acc, idx + 1,"))]


def test_mutation_atomic_in_kernel(tmp_path):
    cu = _copy(tmp_path, "kernels/csrc/flash_attention.cu")
    assert found(str(cu)) == []
    _mutate(cu, "  return cudaGetLastError();\n}\n\n}  // namespace",
            "  return cudaGetLastError();\n}\n\n__device__ void acc(float* "
            "p, float v) { atomicAdd(p, v); }\n\n}  // namespace")
    assert found(str(cu)) == [("DET01", _lineno(cu, "atomicAdd(p, v)"))]
