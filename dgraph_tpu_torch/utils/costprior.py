"""Per-shape cost priors: the deciding half of the cost model.

Port of `dgraph_tpu/utils/costprior.py` with plain `threading` locks
(ROADMAP Queue 1 item 9f); no device code. It turns the cost profile's
digests (utils/costprofile.py) into priors the serving loop consults
BEFORE running a request. Per shape fingerprint the prior is the
percentile blend of the digest, p50 + BLEND·(p90−p50), refit
incrementally as requests complete (an EMA toward the observed cost) and
exactly from the digests on boot. Shapes below `sample_floor`
observations fall back to a per-lane EMA of observed request cost. A
weighted least-squares fit of cost against the per-shape feature means
(`FEATURES`, costprofile's feature fields) covers shapes the digests
have never seen but whose plan features are known at launch time.

Consumers in the port: the batch planner (`engine/batch.py`:
`_kernel_worth` gates a small group by its predicted cost,
`order_plans_by_cost` launches groups longest-first), the request shell
(`Alpha._request` predicts before the serve and learns after it), and
the route EMAs that promote the knn and feat device routes below their
static thresholds (`store/vec.py`, `engine/feat.py`), and admission
(server/admission.py), which takes the request's prediction with its
token.

Live counts: `cost_prior_hits_total{lane=}` and
`cost_prior_fallbacks_total{lane=}`. The model persists as
`costpriors.json` beside `costprofiles.json`; a corrupt file counts in
`sidecar_load_failures_total{file=}` and never aborts a boot.
"""

from __future__ import annotations

import json

import threading

from dgraph_tpu_torch.utils import costprofile
from dgraph_tpu_torch.utils.costprofile import Digest
from dgraph_tpu_torch.utils.metrics import MAX_LABEL_SETS, METRICS

__all__ = ["FEATURES", "SAMPLE_FLOOR", "BLEND", "CostPriorModel",
           "PRIORS", "enabled", "set_enabled", "predict", "lane_ema_us",
           "learn",
           "refit", "status", "save", "load", "reset"]

# ONE feature vocabulary with the runtime cost records: the prior's
# regressors ARE costprofile's feature fields.
FEATURES = tuple(costprofile.FEATURE_FIELDS)

SAMPLE_FLOOR = 8         # observations before a shape prior is trusted
BLEND = 0.5              # predicted = p50 + BLEND * (p90 - p50)
_EMA_ALPHA = 0.2         # incremental refit smoothing (per shape + lane)
LANE_SEED_US = 50_000.0  # lane fallback before any observation (50 ms)
_TEXT_MEMO_MAX = 2048    # query-text → shape memo entries


class CostPriorModel:
    """Shape-keyed cost priors with lane-EMA fallback (see module doc).
    The module-level `PRIORS` instance is the process-wide registry
    (METRICS/COSTS-style); tests construct their own."""

    def __init__(self, sample_floor: int = SAMPLE_FLOOR,
                 max_shapes: int = MAX_LABEL_SETS):
        self._lock = threading.Lock()
        self.sample_floor = int(sample_floor)
        self.max_shapes = int(max_shapes)
        # shape → {"n", "predicted_us", "p50", "p90"}
        self._shapes: dict[str, dict] = {}
        # lane → EMA of observed request µs (the admission fallback)
        self._lane_ema: dict[str, float] = {}
        # execution route (device/numpy/knn_*/feat_*) → EMA of measured
        # µs per 1k edges or rows: the knn and feat route selectors
        # consult these to promote the device route below its static
        # threshold (store/vec.py, engine/feat.py: `promoted`)
        self._route_ema: dict[str, float] = {}
        # query-text hash → shape fingerprint, learned as requests
        # complete (admission predicts BEFORE parsing; the memo is how
        # a repeated template's shape is known pre-parse). Insertion
        # order doubles as the FIFO eviction order.
        self._text_shape: dict[int, str] = {}
        # prediction-accuracy tracking (prior hits only): absolute µs
        # error digest + relative error in 0.1% units
        self._abs_err = Digest()
        self._rel_err = Digest()
        self.hits = 0
        self.fallbacks = 0
        self.refits = 0
        # weighted least-squares fit of p50 cost on feature means
        # (unseen-shape predictor for the batch planner)
        self._fit: dict | None = None

    # -- prediction ----------------------------------------------------------
    def shape_for_text(self, text: str) -> str | None:
        with self._lock:
            return self._text_shape.get(hash(text))

    def predict(self, lane: str, text: str | None = None,
                shape: str | None = None) -> tuple[float, str]:
        """(predicted µs, source): source is "prior" when a trusted
        shape prior answered, else "fallback" (lane EMA). Never raises
        and never parses — one memo lookup + one dict lookup."""
        with self._lock:
            if shape is None and text is not None:
                shape = self._text_shape.get(hash(text))
            p = self._shapes.get(shape) if shape else None
            if p is not None and p["n"] >= self.sample_floor:
                self.hits += 1
                METRICS.inc("cost_prior_hits_total", lane=lane)
                return float(p["predicted_us"]), "prior"
            self.fallbacks += 1
            METRICS.inc("cost_prior_fallbacks_total", lane=lane)
            return float(self._lane_ema.get(lane, LANE_SEED_US)), \
                "fallback"

    def predict_shape(self, shape: str) -> float | None:
        """Trusted per-shape prediction or None — the batch planner's
        lookup (its fallback is the feature fit, then query count)."""
        with self._lock:
            p = self._shapes.get(shape)
            if p is not None and p["n"] >= self.sample_floor:
                return float(p["predicted_us"])
            return None

    def lane_ema_us(self, lane: str) -> float | None:
        """The lane's observed-cost EMA, or None before any completed
        request (the flight recorder's fallback, ROADMAP item 9f)."""
        with self._lock:
            v = self._lane_ema.get(lane)
            return float(v) if v is not None else None

    def predict_features(self, features: dict) -> float | None:
        """Linear-model prediction from plan features (known at launch
        time even for never-digested shapes), or None before a fit."""
        with self._lock:
            fit = self._fit
        if fit is None:
            return None
        us = fit["intercept"]
        for f, w in fit["coef"].items():
            us += w * float(features.get(f, 0))
        return max(us, 0.0)

    # -- route costs (the expansion-path selector's prior) -------------------
    def learn_route(self, path: str, us_per_kedge: float) -> None:
        """Fold one expansion's measured µs-per-1k-edges into the
        path's EMA (called from engine ops.expand on every route)."""
        with self._lock:
            ema = self._route_ema.get(path)
            self._route_ema[path] = (
                float(us_per_kedge) if ema is None
                else ema + _EMA_ALPHA * (float(us_per_kedge) - ema))

    def route_cost(self, path: str) -> float | None:
        """Measured µs/1k-edges EMA for an execution route, or None
        before any observation."""
        with self._lock:
            return self._route_ema.get(path)

    # -- learning ------------------------------------------------------------
    def learn(self, lane: str, text: str | None, shape: str | None,
              actual_us: float, predicted_us: float | None = None,
              source: str | None = None) -> None:
        """Fold one COMPLETED request back in: remember text→shape,
        update the lane EMA and the shape's incremental prior, and —
        when the prediction came from a prior — record its error."""
        actual_us = float(actual_us)
        with self._lock:
            if text is not None and shape:
                h = hash(text)
                if h not in self._text_shape and \
                        len(self._text_shape) >= _TEXT_MEMO_MAX:
                    self._text_shape.pop(next(iter(self._text_shape)))
                self._text_shape[h] = shape
            ema = self._lane_ema.get(lane)
            self._lane_ema[lane] = (actual_us if ema is None
                                    else ema + _EMA_ALPHA
                                    * (actual_us - ema))
            if shape and not self._fold_locked(shape, actual_us):
                return
            if predicted_us is not None and source == "prior":
                self._abs_err.add(abs(actual_us - predicted_us))
                self._rel_err.add(1000.0 * abs(actual_us - predicted_us)
                                  / max(actual_us, 1.0))

    def learn_shape(self, shape: str, actual_us: float) -> None:
        """Fold one measured launch into its shape's incremental prior
        alone (no lane EMA, no text memo): a batch's kernel group under
        its launch shape (engine/batch.py), which a request's shape, the
        whole batch's, never names."""
        with self._lock:
            self._fold_locked(shape, float(actual_us))

    def _fold_locked(self, shape: str, actual_us: float) -> bool:
        """One observation into the shape's incremental prior; False
        when the shape is new and the table is full."""
        p = self._shapes.get(shape)
        if p is None:
            if len(self._shapes) >= self.max_shapes:
                return False
            p = self._shapes[shape] = {
                "n": 0, "predicted_us": actual_us,
                "p50": actual_us, "p90": actual_us}
        p["n"] += 1
        p["predicted_us"] += _EMA_ALPHA * (actual_us - p["predicted_us"])
        return True

    # -- refit from digests --------------------------------------------------
    def refit(self, agg=None, overwrite: bool = True) -> dict:
        """Exact refit from an Aggregator's total_us digests: per shape,
        predicted = p50 + BLEND·(p90−p50). Deterministic for a fixed
        digest set (pinned by tests/test_costprior.py). With
        overwrite=False only shapes the model has never seen are filled
        in (the boot path: the merged costpriors.json keeps its
        incrementally-refined values). Also (re)fits the feature
        least-squares model. Returns a fit summary."""
        import numpy as np
        agg = agg if agg is not None else costprofile.COSTS
        rows_x, rows_y, rows_w = [], [], []
        fitted = 0
        with agg._lock:
            shape_stats = {s: (st.count,
                               st.digests["total_us"].percentile(0.50),
                               st.digests["total_us"].percentile(0.90),
                               dict(st.features))
                           for s, st in agg._shapes.items()}
        with self._lock:
            for shape, (n, p50, p90, feats) in shape_stats.items():
                if not n:
                    continue
                if shape not in self._shapes \
                        and len(self._shapes) >= self.max_shapes:
                    continue
                if overwrite or shape not in self._shapes:
                    self._shapes[shape] = {
                        "n": n,
                        "predicted_us": float(p50 + BLEND * (p90 - p50)),
                        "p50": int(p50), "p90": int(p90)}
                    fitted += 1
                # the fit tolerates a lower bar than per-shape trust:
                # a weighted point with few samples still informs the
                # regression more than silence does
                if n >= max(3, self.sample_floor // 2):
                    rows_x.append([feats.get(f, 0) / n for f in FEATURES]
                                  + [1.0])
                    rows_y.append(float(p50))
                    rows_w.append(float(n))
            self.refits += 1
        fit = None
        if len(rows_x) >= 3:
            x = np.asarray(rows_x, np.float64)
            y = np.asarray(rows_y, np.float64)
            w = np.sqrt(np.asarray(rows_w, np.float64))
            coef, *_ = np.linalg.lstsq(x * w[:, None], y * w,
                                       rcond=None)
            pred = x @ coef
            ss_res = float(((y - pred) ** 2).sum())
            ss_tot = float(((y - y.mean()) ** 2).sum())
            fit = {"coef": {f: round(float(c), 4)
                            for f, c in zip(FEATURES, coef[:-1])},
                   "intercept": round(float(coef[-1]), 2),
                   "r2": round(1.0 - ss_res / ss_tot, 4)
                   if ss_tot > 0 else 0.0,
                   "shapes": len(rows_x)}
            with self._lock:
                self._fit = fit
        return {"shapes_fitted": fitted,
                "shapes_total": len(shape_stats), "fit": fit}

    # -- persistence (beside costprofiles.json) ------------------------------
    def to_state(self) -> dict:
        with self._lock:
            return {"version": 1,
                    "shapes": {s: dict(p)
                               for s, p in self._shapes.items()},
                    "lane_ema": dict(self._lane_ema),
                    "route_ema": dict(self._route_ema)}

    def merge_state(self, state: dict) -> None:
        """Merge a persisted model (boot path): per shape, n-weighted
        mean of predictions; lane EMAs average when both sides exist."""
        for shape, p in state.get("shapes", {}).items():
            n_in = max(int(p.get("n", 0)), 0)
            with self._lock:
                mine = self._shapes.get(shape)
                if mine is None:
                    if len(self._shapes) < self.max_shapes:
                        self._shapes[shape] = {
                            "n": n_in,
                            "predicted_us": float(
                                p.get("predicted_us", 0.0)),
                            "p50": int(p.get("p50", 0)),
                            "p90": int(p.get("p90", 0))}
                    continue
                tot = mine["n"] + n_in
                if tot:
                    mine["predicted_us"] = (
                        mine["predicted_us"] * mine["n"]
                        + float(p.get("predicted_us", 0.0)) * n_in) / tot
                mine["n"] = tot
                mine["p50"] = max(mine["p50"], int(p.get("p50", 0)))
                mine["p90"] = max(mine["p90"], int(p.get("p90", 0)))
        with self._lock:
            for lane, v in state.get("lane_ema", {}).items():
                mine_v = self._lane_ema.get(lane)
                self._lane_ema[lane] = (float(v) if mine_v is None
                                        else (mine_v + float(v)) / 2.0)
            for path, v in state.get("route_ema", {}).items():
                mine_v = self._route_ema.get(path)
                self._route_ema[path] = (float(v) if mine_v is None
                                         else (mine_v + float(v)) / 2.0)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_state(), f)

    def load(self, path: str) -> bool:
        """Merge a persisted model into this one. A missing file is a
        silent no-op; a corrupt/truncated or wrong-shaped one is
        COUNTED and logged but still never aborts the boot — priors
        are telemetry-derived, the model refits from digests."""
        try:
            with open(path) as f:
                state = json.load(f)
            self.merge_state(state)
        except OSError:
            return False
        except Exception:  # noqa: BLE001 — corrupt sidecar: start fresh
            import os

            from dgraph_tpu_torch.utils import logging as xlog
            METRICS.inc("sidecar_load_failures_total",
                        file=os.path.basename(path))
            xlog.get("costprior").warning(
                "corrupt cost-prior sidecar %s ignored; refitting "
                "from digests", path, exc_info=True)
            return False
        return True

    # -- surfacing (Alpha.status, /debug/scheduler) --------------------------
    def status(self, top_n: int = 10) -> dict:
        with self._lock:
            shapes = sorted(self._shapes.items(),
                            key=lambda kv: kv[1]["predicted_us"],
                            reverse=True)
            return {
                "shapes": len(self._shapes),
                "hits": self.hits,
                "fallbacks": self.fallbacks,
                "refits": self.refits,
                "sample_floor": self.sample_floor,
                "lane_ema_us": {ln: round(v, 1)
                                for ln, v in self._lane_ema.items()},
                "route_us_per_kedge": {p: round(v, 2)
                                       for p, v in
                                       self._route_ema.items()},
                "error": {
                    "n": self._abs_err.count,
                    "abs_p50_us": self._abs_err.percentile(0.50),
                    "abs_p90_us": self._abs_err.percentile(0.90),
                    "rel_p50_pct": self._rel_err.percentile(0.50) / 10.0,
                    "rel_p90_pct": self._rel_err.percentile(0.90) / 10.0,
                },
                "fit": self._fit,
                "top": [{"shape": s, "n": p["n"],
                         "predicted_us": round(p["predicted_us"], 1)}
                        for s, p in shapes[:top_n]],
            }

    def clear(self) -> None:
        with self._lock:
            self._shapes.clear()
            self._lane_ema.clear()
            self._route_ema.clear()
            self._text_shape.clear()
            self._abs_err = Digest()
            self._rel_err = Digest()
            self.hits = self.fallbacks = self.refits = 0
            self._fit = None


# -- process-wide registry + module-level convenience wrappers ---------------

PRIORS = CostPriorModel()
_ENABLED = True


def enabled() -> bool:
    return _ENABLED


def set_enabled(flag: bool) -> None:
    """The one off switch, process-wide (the CLI's `--cost_priors` comes
    with ROADMAP Queue 1 item 9f). Disabling stops predictions, the
    batch's cost order and the route promotions, but keeps learned
    state."""
    global _ENABLED
    _ENABLED = bool(flag)


def learn_group(shape: str, actual_us: float) -> None:
    """A kernel group's measured µs into its launch shape's prior, with
    the priors on."""
    if _ENABLED:
        PRIORS.learn_shape(shape, actual_us)


def promoted(route: str, baseline: str) -> bool:
    """Cost-prior promotion below a static threshold (the knn and feat
    route selectors, store/vec.py and engine/feat.py): take `route` when
    its measured µs-per-1k EMA beats `baseline`'s."""
    if not _ENABLED:
        return False
    r = PRIORS.route_cost(route)
    b = PRIORS.route_cost(baseline)
    return r is not None and b is not None and r < b


def predict(lane: str, text: str | None = None,
            shape: str | None = None) -> tuple[float, str]:
    return PRIORS.predict(lane, text=text, shape=shape)


def lane_ema_us(lane: str) -> float | None:
    return PRIORS.lane_ema_us(lane)


def learn(lane: str, text: str | None, shape: str | None,
          actual_us: float, predicted_us: float | None = None,
          source: str | None = None) -> None:
    PRIORS.learn(lane, text, shape, actual_us,
                 predicted_us=predicted_us, source=source)


def refit(agg=None, overwrite: bool = True) -> dict:
    return PRIORS.refit(agg=agg, overwrite=overwrite)


def status(top_n: int = 10) -> dict:
    return PRIORS.status(top_n=top_n)


def save(path: str) -> None:
    PRIORS.save(path)


def load(path: str) -> bool:
    return PRIORS.load(path)


def reset() -> None:
    """Test hook: forget every prior, memo, and counter."""
    PRIORS.clear()
