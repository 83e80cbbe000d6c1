"""A tiny copy of the benchmark for the CPU tests: the tree of
`perfbench/` and `BENCHMARK.json` copied under a directory, with tiny
configurations and cells added as new files and entries (nothing that is
there is edited), so that a whole run takes about a second on the CPU."""
from __future__ import annotations

import contextlib
import json
import shutil
from pathlib import Path

import torch

from perfbench import harness

# the `mdna` and `imdb` configuration files cut to a few dozen documents
# (`mdna` has no cell on the card yet); the routes are the traffic files'
# own but for 2 sweeps a launch, since 8 would be all of training here
TINY = {"n_docs": 96, "n_train": 64, "vocab_size": 60, "n_topics": 4,
        "doc_len": 16, "n_iters": 5, "n_pred_burnin": 2,
        "n_pred_samples": 2}
TRAFFIC = {
    "tiny-weighted": {"kind": "fit", "algorithm": "weighted",
                      "sweeps_per_launch": 2, "length_buckets": 0,
                      "sampler_mode": "dense"},
    "tiny-simple-buckets": {"kind": "fit", "algorithm": "simple",
                            "sweeps_per_launch": 2, "length_buckets": 3,
                            "sampler_mode": "dense"}}
CELLS = (("tiny-mdna-weighted", "tiny-mdna", "tiny-weighted"),
         ("tiny-imdb-weighted", "tiny-imdb", "tiny-weighted"),
         ("tiny-imdb-simple-buckets", "tiny-imdb", "tiny-simple-buckets"))


def tiny_root(dest: Path) -> Path:
    """`dest` holding a copy of the benchmark with the tiny cells."""
    shutil.copytree(harness.BENCH, dest / harness.BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = harness.read_spec()
    for name in ("mdna", "imdb"):
        config = json.loads(
            (harness.BENCH / "configs" / f"{name}.json").read_text())
        config.update(TINY, name=f"tiny-{name}")
        path = f"perfbench/configs/tiny-{name}.json"
        (dest / path).write_text(json.dumps(config))
        spec["configs"].append({
            "name": f"tiny-{name}", "source": config["source"][:200],
            "file": path, "reduced": sorted(TINY),
            "why": f"the {name} configuration cut to a few dozen documents"})
    for name, traffic in TRAFFIC.items():
        (dest / "perfbench" / "traffic" / f"{name}.json").write_text(
            json.dumps(traffic))
    for cell, config, traffic in CELLS:
        spec["workloads"].append({"name": cell, "config": config,
                                  "traffic": traffic, "chips": 1,
                                  "why": "tiny, for the CPU tests"})
        for m in spec["per_layer"]:
            if "workloads" in m:
                m["workloads"].append(cell)
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return dest


@contextlib.contextmanager
def one_thread():
    """Torch on one thread for the block: a tiny run only loses to the
    threads' overhead, and the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
