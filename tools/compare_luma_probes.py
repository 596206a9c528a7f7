"""The LUMA protocol's predictions, the JAX package against the PyTorch
port, on the CPU: how many distinct classes each model predicts.

    PYTHONHASHSEED=0 JAX_PLATFORMS=cpu python tools/compare_luma_probes.py \\
        --out luma_probes --seeds 0 1 2

writes ``make_fake_luma``'s corpus of 42 + 8 OOD classes with 100 train
and 20 test rows each (seed 0, the corpus of ``chip_smoke.py`` phase 22)
under ``--out``, then runs ``runners/run_luma.py`` of each package on it for
each seed, one process per run (``--device cpu`` for the port; the hash
text features are salted per process, so fix ``PYTHONHASHSEED``). Every
evaluation's fused predictions are recorded (accuracy, a histogram over the
classes, the number of distinct classes predicted, the same per view) and
the table of distinct classes per model is printed as one JSON line.
Network access is refused in every run: the JAX loader probes a hub for
its tokenizer first. A run takes a few minutes and ~2 GiB; run one at a
time.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
MODELS = ["dmvae_dis", "dmvae_cml", "dmvae_joint", "dbf_fusion", "cml_fusion", "avg_fusion"]
CORPUS = dict(n_classes=42, train_per_class=100, test_per_class=20, ood_classes=8, seed=0)


def _refuse_network():
    def refuse(*args, **kwargs):
        raise OSError("network access is refused")

    socket.create_connection = refuse
    real = socket.socket.connect

    def connect(self, address):
        if isinstance(address, tuple) and address and address[0] not in ("127.0.0.1", "::1",
                                                                          "localhost"):
            raise OSError("network access is refused")
        return real(self, address)

    socket.socket.connect = connect


def run_one(which, seed, corpus, out):
    """One package's run_luma on ``corpus`` for ``seed``, its evaluations
    recorded into ``out`` (JSON)."""
    import importlib

    import numpy as np

    _refuse_network()
    sys.path.insert(0, str(REPO))
    package = "disentagled_multimodal_fusion_tpu" + ("_torch" if which == "port" else "")
    analysis = importlib.import_module(package + ".eval.analysis")
    records, real = [], analysis.evaluate_evidences

    def host(a):
        return np.asarray(a.detach().cpu() if hasattr(a, "detach") else a)

    def recorded(evidences, fused, target, num_classes, *args, **kwargs):
        ev, pred, y = host(evidences), host(fused).argmax(-1), host(target)
        records.append({"accuracy": float((pred == y).mean()),
                        "histogram": np.bincount(pred, minlength=num_classes).tolist(),
                        "distinct": int(len(np.unique(pred))),
                        "distinct_per_view": [int(len(np.unique(ev[:, v].argmax(-1))))
                                              for v in range(ev.shape[1])]})
        return real(evidences, fused, target, num_classes, *args, **kwargs)

    analysis.evaluate_evidences = recorded
    os.chdir(Path(out).parent)
    runner = importlib.import_module(package + ".runners.run_luma")
    runner.main(["--data-path", corpus, "--seeds", str(seed)]
                + (["--device", "cpu"] if which == "port" else []))
    Path(out).write_text(json.dumps(dict(zip(MODELS, records)), indent=1))


def main():
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--out", required=True, help="directory for the corpus and the runs")
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    parser.add_argument("--one", nargs=4, metavar=("PACKAGE", "SEED", "CORPUS", "OUT"),
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.one:
        which, seed, corpus, out = args.one
        return run_one(which, int(seed), corpus, out)
    sys.path.insert(0, str(REPO))
    from disentagled_multimodal_fusion_tpu_torch.data.luma import make_fake_luma

    root = Path(args.out).resolve()
    corpus = root / "corpus"
    if not corpus.exists():
        make_fake_luma(str(corpus), **CORPUS)
    table = {}
    for seed in args.seeds:
        for which in ("port", "jax"):
            run_dir = root / f"{which}{seed}"
            run_dir.mkdir(parents=True, exist_ok=True)
            out = run_dir / "predictions.json"
            with open(run_dir / "log.txt", "w") as log:
                subprocess.run([sys.executable, __file__, "--out", str(root), "--one", which,
                                str(seed), str(corpus), str(out)], stdout=log,
                               stderr=subprocess.STDOUT, check=True)
            rec = json.loads(out.read_text())
            table[f"{which} seed {seed}"] = {m: (round(r["accuracy"], 4), r["distinct"])
                                             for m, r in rec.items()}
    print(json.dumps(table))


if __name__ == "__main__":
    main()
