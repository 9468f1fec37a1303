"""A configuration, a traffic mix and a metric added as new files are found by name."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TOY_CELL = '''
import torch


class Cell:
    def __init__(self, config, traffic, seed, device):
        self.x = torch.arange(config["width"], dtype=torch.float32) + seed % 7
        self.scale = traffic["scale"]
        self.log = []

    def feed(self):
        return (self.x,)

    def call(self, x):
        return x * self.scale

    def advance(self, y):
        self.log.append(float(y.sum()))
        return int(y.numel())

    def keep(self, y):
        return y

    def work(self, first, last):
        return 8.0 * self.x.numel() * (last - first), float(self.x.numel()) * (last - first)

    def release(self):
        pass

    def check(self, kept, limits):
        err = max(float((y - self.x * self.scale).abs().max()) for _, y in kept)
        return [("rel_err", err, limits["rel_err"])], 0
'''

TOY_METRIC = '''
def read(run):
    return float(run.chunks)
'''


def digests(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_mix_and_metric_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".pytest_cache"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = digests(tmp_path / "portbench")

    pb = tmp_path / "portbench"
    (pb / "configs" / "toy_config.py").write_text(TOY_CELL)
    (pb / "configs" / "toy_config.json").write_text(json.dumps({"width": 64}))
    (pb / "reference" / "toy_config.py").write_text('"""x * scale."""\n')
    (pb / "traffic" / "toy_mix.json").write_text(json.dumps(
        {"scale": 3.0, "warm_chunks": 1, "check_chunks": 2, "trace_chunks": 4,
         "limits": {"rel_err": 0.0}}))
    (pb / "metrics" / "toy.chunks_seen.py").write_text(TOY_METRIC)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy_config", "source": "https://example.org/toy",
                             "file": "portbench/configs/toy_config.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "toy.cell", "config": "toy_config", "traffic": "toy_mix",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "toy.chunks_seen", "unit": "chunks", "better": "higher",
                               "source": "program_counter", "layer": "toy", "moves": "msamples_s",
                               "workloads": ["toy.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    # no file that was there changed: only new files and new entries
    after = digests(pb)
    assert {k: after[k] for k in before} == before

    code = ("import json, sys\n"
            "from portbench import run\n"
            "bench = json.load(open('BENCHMARK.json'))\n"
            "out = [run.run_cell(bench, 'toy.cell', 12, 0.05, t, device='cpu') for t in (0, 1)]\n"
            "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    plain, traced = json.loads(proc.stdout.strip().splitlines()[-1])
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"msamples_s", "chunk_ms_p95", "setup_s"}
    assert plain["metrics"]["msamples_s"]["value"] > 0
    assert set(traced["metrics"]) == {"toy.chunks_seen"}
    assert traced["metrics"]["toy.chunks_seen"] == {"value": float(traced["attempted"]),
                                                    "unit": "chunks"}
    assert "toy.chunks_seen" not in plain["metrics"]
    assert list(traced)[-1] == "checks"
