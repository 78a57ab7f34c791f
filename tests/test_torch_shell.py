"""The port's desktop shell (cbas_tpu_torch/shell/), a copy of shell/ that
spawns the port's backend.

The copy is held to its original apart from hunks listed by name with their
reasons; its backend contract (the ready line the shell scrapes, the
arguments it spawns, SIGTERM to the backend's process group) is driven
through chip_smoke.py's shell phase, which runs the same code on the card.
Electron is not installed here, so no test opens the window itself.
"""

import ast
import os
import re
import subprocess
import sys

import pytest

import chip_smoke
from test_torch_copies import _changed_lines

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Per file: (name, reason, patterns of the changed lines); a file not listed
# has no change.
SHELL_HUNKS = {
    "main.js": [
        ("backend module", "the shell spawns the port's backend; no --device, so it runs on "
         "the card, and without one it exits 2 naming CUDA and the exit dialog shows", (
            r"-//   1\. spawn the backend \(python -m cbas_tpu\.app\.main\)",
            r"\+//   1\. spawn the backend \(python -m cbas_tpu_torch\.app\.main\)",
            r"-const BACKEND_ARGS = \['-m', 'cbas_tpu\.app\.main', '--port', '0'\];",
            r"\+const BACKEND_ARGS = \['-m', 'cbas_tpu_torch\.app\.main', '--port', '0'\];",
        )),
        ("repo-root paths", "the copy sits a level deeper: the backend's working directory "
         "(its --frontend default) and the venv/ lookup stay at the repository root", (
            r"-const repoRoot = path\.join\(__dirname, '\.\.'\);",
            r"\+const repoRoot = path\.join\(__dirname, '\.\.', '\.\.'\);",
            r"-cwd: path\.join\(__dirname, '\.\.'\),",
            r"\+cwd: path\.join\(__dirname, '\.\.', '\.\.'\),",
        )),
    ],
    "package.json": [
        ("app name", "Electron's single-instance lock and user-data directory key on the "
         "name: under the same one, the second shell would only focus the first's window", (
            r'-"name": "cbas-tpu-shell",',
            r'\+"name": "cbas-tpu-torch-shell",',
        )),
    ],
}


@pytest.mark.parametrize("name", sorted(os.listdir(os.path.join(ROOT, "shell"))))
def test_shell_copy_matches_original(name):
    changed = _changed_lines(os.path.join("shell", name), original_root="", rename=False)
    listed = [(hunk, p) for hunk, _, patterns in SHELL_HUNKS.get(name, []) for p in patterns]
    for line in changed:
        assert any(re.fullmatch(p, line) for _, p in listed), f"unlisted change: {line!r}"
    for hunk, p in listed:
        assert any(re.fullmatch(p, line) for line in changed), f"{hunk!r}: {p} matches no change"


def test_chip_smoke_shell_phase_runs_on_cpu(monkeypatch):
    """The shell phase with ``--device cpu`` appended: the ready line, the
    status before and after load_project, the page, SIGTERM to the group."""
    # The backend's encode worker starts on the demo clips as the project
    # loads: two threads, not every core, beside the other test workers.
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    line = chip_smoke.shell_phase("cpu", device="cpu")
    assert line["ok"] and line["encoder_device"] == "cpu"
    assert line["backend_args"] == chip_smoke.shell_contract()[1]
    assert line["backend_args"][:2] == ["-m", "cbas_tpu_torch.app.main"]
    assert "--device" not in line["backend_args"]
    assert line["exit_s"] < chip_smoke.SHELL_EXIT_S


def test_backend_args_without_a_card_exit_naming_cuda():
    """The shell's exact arguments on a host with no card: the backend exits
    non-zero naming CUDA and prints no ready line, so the shell shows its
    exit dialog instead of a window on the CPU."""
    ready_re, backend_args = chip_smoke.shell_contract()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(CUDA_VISIBLE_DEVICES="", PYTHONUNBUFFERED="1")
    proc = subprocess.run([sys.executable, *backend_args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode != 0
    assert "CUDA" in proc.stdout + proc.stderr
    assert not ready_re.search(proc.stdout)


def test_backend_ready_line_matches_the_shell_regex():
    """Each ready line cbas_tpu_torch/app/main.py prints (Eel's and the
    built-in server's) is matched by the copy's READY_RE, which captures its
    URL."""
    path = os.path.join(ROOT, "cbas_tpu_torch", "app", "main.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    lines = [
        eval(compile(ast.Expression(node.args[0]), path, "eval"), {"port": 8123})
        for node in ast.walk(tree)
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "print"
        and node.args and isinstance(node.args[0], ast.JoinedStr)
    ]
    assert len(lines) == 2
    ready_re, _ = chip_smoke.shell_contract()
    for line in lines:
        m = ready_re.search(line)
        assert m and m.group(1) == "http://localhost:8123", line
