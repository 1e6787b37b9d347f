"""sgRNAScorer 2.0 model: feature encoding, training, weight export.

Replaces the reference ``trainModel`` utility
(/root/reference/src/crackling/utils/trainModel.py): trains a linear SVC on
high/low-activity spacer sets and exports the model. The default training
data (Chari et al. 2015) ships in ``data/sgrnascorer2_training.json``; the
shipped pre-trained weights live in ``data/sgrnascorer2_model.json`` (both
consumed by ops/efficiency.py at scoring time).

Training uses scikit-learn's SVC when available (the reference trainer's
exact code path); otherwise a pure-numpy SMO solver for the same linear-SVC
dual problem (C=1), which produces the same decision function up to solver
tolerance.
"""

from __future__ import annotations

import argparse
import json
from importlib import resources

import numpy as np

# Reference one-hot encoding (trainModel.py:29-46): channel order G,T,C,A.
ENCODING = {
    "A": "0001", "C": "0010", "T": "0100", "G": "1000",
    "K": "1100", "M": "0011", "R": "1001", "Y": "0110",
    "S": "1010", "W": "0101", "B": "1110", "V": "1011",
    "H": "0111", "D": "1101", "N": "1111",
}


def encode_spacers(seqs: list[str], spacer_length: int = 20) -> np.ndarray:
    """(n, 4*spacer_length) features with the reference offset rules
    (trainModel.py:50-66): sequences longer than 20 use the first 20."""
    length = min(spacer_length, 20)
    feats = np.zeros((len(seqs), length * 4), dtype=np.float64)
    for i, s in enumerate(seqs):
        s = s.strip().upper()
        for x in range(length):
            for y in range(4):
                feats[i, x * 4 + y] = int(ENCODING[s[x]][y])
    return feats


def _train_smo(x: np.ndarray, y: np.ndarray, c: float = 1.0,
               tol: float = 1e-6, max_passes: int = 200, seed: int = 0):
    """Simplified SMO for the linear-SVC dual (Platt 1998). Returns (w, b)."""
    n = x.shape[0]
    k = x @ x.T
    alpha = np.zeros(n)
    b = 0.0
    rng = np.random.default_rng(seed)
    passes = 0
    while passes < max_passes:
        changed = 0
        for i in range(n):
            ei = (alpha * y) @ k[:, i] + b - y[i]
            if (y[i] * ei < -tol and alpha[i] < c) or (y[i] * ei > tol and alpha[i] > 0):
                j = int(rng.integers(0, n - 1))
                j = j + 1 if j >= i else j
                ej = (alpha * y) @ k[:, j] + b - y[j]
                ai, aj = alpha[i], alpha[j]
                if y[i] != y[j]:
                    lo, hi = max(0.0, aj - ai), min(c, c + aj - ai)
                else:
                    lo, hi = max(0.0, ai + aj - c), min(c, ai + aj)
                if lo == hi:
                    continue
                eta = 2.0 * k[i, j] - k[i, i] - k[j, j]
                if eta >= 0:
                    continue
                aj_new = np.clip(aj - y[j] * (ei - ej) / eta, lo, hi)
                if abs(aj_new - aj) < 1e-7:
                    continue
                ai_new = ai + y[i] * y[j] * (aj - aj_new)
                alpha[i], alpha[j] = ai_new, aj_new
                b1 = b - ei - y[i] * (ai_new - ai) * k[i, i] - y[j] * (aj_new - aj) * k[i, j]
                b2 = b - ej - y[i] * (ai_new - ai) * k[i, j] - y[j] * (aj_new - aj) * k[j, j]
                if 0 < ai_new < c:
                    b = b1
                elif 0 < aj_new < c:
                    b = b2
                else:
                    b = (b1 + b2) / 2.0
                changed += 1
        passes = passes + 1 if changed == 0 else 0
    w = (alpha * y) @ x
    return w, b


def train(good_seqs: list[str], bad_seqs: list[str], spacer_length: int = 20):
    """Train the linear SVC; returns (weights (80,), intercept)."""
    x = np.vstack([encode_spacers(good_seqs, spacer_length),
                   encode_spacers(bad_seqs, spacer_length)])
    y = np.concatenate([np.ones(len(good_seqs)), -np.ones(len(bad_seqs))])
    try:
        from sklearn.svm import SVC

        clf = SVC(kernel="linear")
        clf.fit(x, y)
        return clf.coef_.ravel().astype(np.float64), float(clf.intercept_[0])
    except ImportError:
        return _train_smo(x, y)


def default_training_data():
    with resources.files("crackling_tpu_torch.data").joinpath(
        "sgrnascorer2_training.json"
    ).open() as fp:
        d = json.load(fp)
    return d["high_activity"], d["low_activity"]


def save_model_json(weights: np.ndarray, intercept: float, path: str):
    json.dump(
        {
            "_citation": "Linear SVM for sgRNAScorer 2.0 (Chari et al. 2015)."
            " Feature layout: 20 positions x 4 one-hot channels (G,T,C,A).",
            "weights": [float(w) for w in weights],
            "intercept": float(intercept),
        },
        open(path, "w"),
    )


def main_train(argv=None):
    """``trainModel`` CLI. With no args, retrains the shipped model from the
    shipped data (reference trainModel.py:119-126)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-g", "--good", type=argparse.FileType("r"))
    parser.add_argument("-b", "--bad", type=argparse.FileType("r"))
    parser.add_argument("-s", "--spacerLength", type=int, default=20)
    parser.add_argument("-p", "--pamOrientation", default="3")
    parser.add_argument("-l", "--pamLength", default="NGG")
    parser.add_argument("-o", "--svmOutput", default=None,
                        help="output model path (.json weights; .txt via joblib)")
    args = parser.parse_args(argv)

    if args.good and args.bad:
        good = [l.strip() for l in args.good if l.strip()]
        bad = [l.strip() for l in args.bad if l.strip()]
    else:
        print("Using default arguments")
        good, bad = default_training_data()

    w, b = train(good, bad, args.spacerLength)
    out = args.svmOutput or "model.json"
    if out.endswith(".json"):
        save_model_json(w, b, out)
    else:
        # joblib/sklearn dump for reference compatibility
        from sklearn.svm import SVC
        from joblib import dump

        x = np.vstack([encode_spacers(good, args.spacerLength),
                       encode_spacers(bad, args.spacerLength)])
        y = np.concatenate([np.ones(len(good)), -np.ones(len(bad))])
        clf = SVC(kernel="linear")
        clf.fit(x, y)
        dump(clf, out, compress=True)
    print("Finished")
