"""Online calibration of the §4.4 model from recorded dispatches (§4.4c).

The analytic model ships with nominal constants (per-link bandwidths from
the topology, :data:`~repro_torch.core.pipelining.DEFAULT_LAUNCH_MODEL` for
launch overheads). Real machines diverge — De Sensi et al. measure
per-link effective bandwidth far off nominal — so this module closes the
loop: it regresses the model's terms from the
:class:`~repro_torch.comm.telemetry.DispatchSample` stream and persists them as
a :class:`CalibrationProfile` keyed by the topology's structural digest.

Fitting contract (robustness gates, DESIGN §4.4c):

* **warmup** — the first ``warmup`` samples of every distinct sample
  signature are dropped (first dispatches pay compilation/alloc noise);
* **minimum samples** — a per-link bandwidth (or the launch model) is
  only emitted once backed by ``min_samples`` observations, so a single
  outlier can never flip an arbitration;
* **exponential decay** — bandwidth estimates update multiplicatively in
  log space with per-sample gain ``decay``, so drift is tracked while
  old evidence decays geometrically;
* **ratio clamp** — one sample can move an estimate by at most a factor
  of ``max_ratio``, bounding the damage of a mis-attributed stall.

Consumption contract: a profile attaches via
:meth:`repro_torch.core.topology.Topology.set_calibration`, which *validates*
the digest match (wrong-machine profiles are refused) and bumps the plan
epoch so every cached arbitration is re-derived from fitted terms. The
profile file is versioned (:data:`PROFILE_VERSION`); loading a payload
with a different version raises rather than misinterpreting fields.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
from collections import defaultdict
from typing import TYPE_CHECKING, Iterable, Sequence

from repro_torch.core.pipelining import DEFAULT_LAUNCH_MODEL, LaunchModel
from repro_torch.core.topology import HOST, Topology

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.comm.telemetry import DispatchSample

#: On-disk schema version. Bump on any incompatible payload change; the
#: loader validates it and refuses (raises) on mismatch — a stale file
#: must never be silently reinterpreted.
PROFILE_VERSION = 1

_LinkKey = tuple  # (src, dst)


def _wire_model_s(routes, window: int,
                  bw_gbps: dict[_LinkKey, float]
                  ) -> tuple[float, tuple[_LinkKey, ...]]:
    """Closed-form §4.4 wire time of a sample's recorded routes under a
    bandwidth map, plus the critical path's links (for attribution)."""
    counts: dict[_LinkKey, int] = defaultdict(int)
    host_paths = 0
    for msg in routes:
        for (links, _nbytes, _nchunks) in msg:
            for ln in links:
                counts[ln] += 1
            if any(HOST in ln for ln in links):
                host_paths += 1
    best, crit = 0.0, ()
    for msg in routes:
        for (links, nbytes, nchunks) in msg:
            n = max(1, nchunks)
            chunk_bytes = nbytes / n
            hop_times = []
            for ln in links:
                bw = bw_gbps.get(ln)
                if not bw or bw <= 0:
                    return 0.0, ()  # unknown link: cannot model
                share = max(1, counts[ln])
                if HOST in ln and host_paths > 1:
                    share = max(share, host_paths)
                hop_times.append(chunk_bytes / (bw * 1e9 / share))
            t = sum(hop_times) + (n - 1) * max(hop_times)
            if t > best:
                best, crit = t, links
    return best * max(1, window), crit


def _wls_line(points: Sequence[tuple[float, float, float]]
              ) -> tuple[float, float]:
    """Weighted least-squares line fit ``y = slope*x + intercept`` over
    ``(x, y, weight)`` triples (>= 2 distinct x assumed)."""
    wsum = sum(w for _, _, w in points)
    xbar = sum(w * x for x, _, w in points) / wsum
    ybar = sum(w * y for _, y, w in points) / wsum
    den = sum(w * (x - xbar) ** 2 for x, _, w in points)
    if den <= 0:
        return 0.0, ybar
    slope = sum(w * (x - xbar) * (y - ybar) for x, y, w in points) / den
    return slope, ybar - slope * xbar


def _fit_line_ns(pairs: Sequence[tuple[int, float]],
                 default_slope: float) -> tuple[float, float]:
    """Robust per-node-count regression: median ns per distinct node
    count, then a weighted line, clamped to non-negative terms."""
    by_n: dict[int, list[float]] = defaultdict(list)
    for n, v in pairs:
        by_n[n].append(v)
    meds = [(float(n), statistics.median(vs), float(len(vs)))
            for n, vs in sorted(by_n.items())]
    if len(meds) >= 2:
        slope, intercept = _wls_line(meds)
        if slope < 0:
            slope = 0.0
            intercept = (sum(m[1] * m[2] for m in meds)
                         / sum(m[2] for m in meds))
    else:
        (x0, y0, _), = meds
        slope = default_slope
        intercept = y0 - x0 * slope
    return max(0.0, slope), max(0.0, intercept)


@dataclasses.dataclass(frozen=True)
class CalibrationProfile:
    """Fitted §4.4 model terms for ONE topology shape, persistable as JSON.

    The identity invariant: :attr:`topology_digest` is the structural
    digest (:meth:`repro_torch.core.topology.Topology.digest`) of the machine
    the samples came from; :meth:`~repro_torch.core.topology.Topology.\
    set_calibration` validates it and refuses a mismatch, so fitted
    terms can never be applied to a different link graph. ``link_bandwidth_gbps``
    holds only links that passed the fitter's minimum-sample gate;
    ``launch`` is ``None`` when launch terms did not (consumers fall
    back to :data:`~repro_torch.core.pipelining.DEFAULT_LAUNCH_MODEL`).
    ``kernel_cost_ns`` maps kernel names to fitted median execute ns —
    the per-kernel compute term that replaces the ``COMPUTE_GFLOPS``
    constant in :func:`~repro_torch.core.pipelining.compute_time_s` when the
    profile is attached; empty when no kernel evidence passed the gate.
    """

    topology_digest: str
    link_bandwidth_gbps: dict[_LinkKey, float] = dataclasses.field(
        default_factory=dict)
    launch: LaunchModel | None = None
    link_samples: dict[_LinkKey, int] = dataclasses.field(
        default_factory=dict)
    launch_samples: int = 0
    kernel_cost_ns: dict[str, float] = dataclasses.field(
        default_factory=dict)
    kernel_samples: dict[str, int] = dataclasses.field(
        default_factory=dict)
    version: int = PROFILE_VERSION

    def summary(self) -> dict:
        """Compact schema-stable dict for ``session.describe()``:
        digest, fitted-link count, whether launch terms are live,
        fitted-kernel count — enough to audit which terms an
        arbitration consumed."""
        return {"topology_digest": self.topology_digest,
                "version": self.version,
                "links_fitted": len(self.link_bandwidth_gbps),
                "launch_fitted": self.launch is not None,
                "launch_samples": self.launch_samples,
                "kernels_fitted": len(self.kernel_cost_ns)}

    def to_payload(self) -> dict:
        """Versioned JSON-safe payload (the inverse of
        :meth:`from_payload`; round-trip is validated by the test
        suite). Link keys serialize as ``"src,dst"`` strings."""
        return {
            "version": self.version,
            "topology_digest": self.topology_digest,
            "links": {f"{s},{d}": {"bandwidth_gbps": bw,
                                   "samples": self.link_samples.get(
                                       (s, d), 0)}
                      for (s, d), bw in sorted(
                          self.link_bandwidth_gbps.items())},
            "launch": (dataclasses.asdict(self.launch)
                       if self.launch is not None else None),
            "launch_samples": self.launch_samples,
            "kernels": {name: {"cost_ns": cost,
                               "samples": self.kernel_samples.get(name, 0)}
                        for name, cost in sorted(
                            self.kernel_cost_ns.items())},
        }

    @classmethod
    def from_payload(cls, payload: dict) -> "CalibrationProfile":
        """Parse a payload produced by :meth:`to_payload`, validating
        the schema version — a mismatched :data:`PROFILE_VERSION`
        raises ``ValueError`` instead of misreading fields."""
        version = payload.get("version")
        if version != PROFILE_VERSION:
            raise ValueError(
                f"calibration profile version {version!r} != supported "
                f"{PROFILE_VERSION} — refusing to reinterpret")
        links, counts = {}, {}
        for key, entry in payload.get("links", {}).items():
            s, d = (int(x) for x in key.split(","))
            links[(s, d)] = float(entry["bandwidth_gbps"])
            counts[(s, d)] = int(entry.get("samples", 0))
        raw = payload.get("launch")
        launch = LaunchModel(**raw) if raw is not None else None
        kernels, kcounts = {}, {}
        for name, entry in payload.get("kernels", {}).items():
            kernels[name] = float(entry["cost_ns"])
            kcounts[name] = int(entry.get("samples", 0))
        return cls(topology_digest=str(payload["topology_digest"]),
                   link_bandwidth_gbps=links, launch=launch,
                   link_samples=counts,
                   launch_samples=int(payload.get("launch_samples", 0)),
                   kernel_cost_ns=kernels, kernel_samples=kcounts)

    def filename(self) -> str:
        """Canonical per-digest file name — one profile per machine
        shape in a profiles dir, so load-on-init can key lookup by the
        session topology's digest."""
        return f"profile-{self.topology_digest}.json"

    def save(self, profiles_dir: str) -> str:
        """Persist under ``profiles_dir`` (created if missing) at the
        digest-keyed :meth:`filename`; returns the written path. The
        payload is the versioned :meth:`to_payload` schema."""
        os.makedirs(profiles_dir, exist_ok=True)
        path = os.path.join(profiles_dir, self.filename())
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(self.to_payload(), fh, indent=2, sort_keys=True)
        return path

    @classmethod
    def load(cls, path: str) -> "CalibrationProfile":
        """Read one profile file; raises ``ValueError`` on a version
        mismatch (see :meth:`from_payload`) and ``OSError`` if
        unreadable."""
        with open(path, encoding="utf-8") as fh:
            return cls.from_payload(json.load(fh))

    @classmethod
    def load_for(cls, topology: Topology,
                 profiles_dir: str) -> "CalibrationProfile | None":
        """Load the profile matching ``topology.digest()`` from a
        profiles dir, or ``None`` when absent. A file whose recorded
        digest contradicts its digest-keyed name raises ``ValueError``
        — the wrong-machine refusal invariant."""
        digest = topology.digest()
        path = os.path.join(profiles_dir, f"profile-{digest}.json")
        if not os.path.exists(path):
            return None
        profile = cls.load(path)
        if profile.topology_digest != digest:
            raise ValueError(
                f"profile at {path} carries digest "
                f"{profile.topology_digest!r} but topology digest is "
                f"{digest!r}")
        return profile


class CalibrationFitter:
    """Regress §4.4 model terms from a chronological sample stream.

    Implements the §4.4c fitting contract documented in the module
    docstring: warmup dropping per sample signature, minimum-sample
    gating before any term is emitted, multiplicative exponential-decay
    bandwidth updates clamped to ``max_ratio`` per observation, and a
    median-based robust line fit for the launch/instantiate terms.
    """

    def __init__(self, topology: Topology, *, min_samples: int = 3,
                 warmup: int = 1, decay: float = 0.5,
                 max_ratio: float = 16.0):
        if min_samples < 1:
            raise ValueError(f"min_samples must be >= 1, got {min_samples}")
        if warmup < 0:
            raise ValueError(f"warmup must be >= 0, got {warmup}")
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        if max_ratio <= 1.0:
            raise ValueError(f"max_ratio must be > 1, got {max_ratio}")
        self.topology = topology
        self.min_samples = min_samples
        self.warmup = warmup
        self.decay = decay
        self.max_ratio = max_ratio

    def _drop_warmup(self, samples: Iterable["DispatchSample"]
                     ) -> list["DispatchSample"]:
        """Drop the first ``warmup`` samples per signature (outlier
        robustness: first dispatches carry compile/alloc noise that
        would otherwise contaminate every fitted term)."""
        seen: dict[tuple, int] = defaultdict(int)
        out = []
        for s in samples:
            seen[s.signature] += 1
            if seen[s.signature] > self.warmup:
                out.append(s)
        return out

    def _fit_launch(self, samples: Sequence["DispatchSample"]
                    ) -> tuple[LaunchModel | None, int]:
        """Fit graph launch + instantiate terms from (node count,
        measured ns) pairs — median per node count then a weighted
        line, gated by ``min_samples`` (else ``None``). Captured-step
        samples (non-empty ``compute``) are excluded — a kernel node's
        launch cost is not a copy node's, and pooling them would bend
        the fitted per-node slope (§4.4c signature invariant)."""
        samples = [s for s in samples if not getattr(s, "compute", ())]
        launch_pts = [(s.num_nodes, float(s.stages.launch_ns))
                      for s in samples if s.stages.launch_ns > 0]
        if len(launch_pts) < self.min_samples:
            return None, 0
        slope, base = _fit_line_ns(
            launch_pts, DEFAULT_LAUNCH_MODEL.graph_launch_per_node_ns)
        fitted = dataclasses.replace(
            DEFAULT_LAUNCH_MODEL,
            graph_launch_base_ns=base, graph_launch_per_node_ns=slope)
        inst_pts = [(s.num_nodes, float(s.stages.compile_ns))
                    for s in samples if s.stages.compile_ns > 0]
        if len(inst_pts) >= self.min_samples:
            islope, ibase = _fit_line_ns(
                inst_pts,
                DEFAULT_LAUNCH_MODEL.graph_instantiate_per_node_ns)
            fitted = dataclasses.replace(
                fitted, graph_instantiate_base_ns=ibase,
                graph_instantiate_per_node_ns=islope)
        return fitted, len(launch_pts)

    def _fit_bandwidth(self, samples: Sequence["DispatchSample"]
                       ) -> tuple[dict[_LinkKey, float],
                                  dict[_LinkKey, int]]:
        """Chronological multiplicative EMA over critical-path links:
        each sample moves its bottleneck links' estimates by
        ``ratio**-decay`` (ratio = measured/modeled, clamped to
        ``max_ratio``) — time scales as 1/bandwidth, so a slow link is
        attributed a proportionally lower fitted bandwidth.

        Captured-step samples (non-empty ``compute`` identity) are
        excluded: their execute time includes kernel work the wire model
        cannot attribute to links, so pooling them would corrupt the
        fitted bandwidths — the §4.4c signature invariant."""
        est = {k: ln.bandwidth_gbps
               for k, ln in self.topology.links.items()}
        counts: dict[_LinkKey, int] = defaultdict(int)
        for s in samples:
            if getattr(s, "compute", ()):
                continue
            measured = s.stages.execute_ns / 1e9
            if measured <= 0:
                continue
            modeled, crit = _wire_model_s(s.routes, s.window, est)
            if modeled <= 0 or not crit:
                continue
            ratio = min(self.max_ratio,
                        max(1.0 / self.max_ratio, measured / modeled))
            step = ratio ** (-self.decay)
            for ln in crit:
                est[ln] *= step
                counts[ln] += 1
        fitted = {k: round(est[k], 6) for k, c in counts.items()
                  if c >= self.min_samples}
        return fitted, {k: counts[k] for k in fitted}

    def _fit_kernels(self, kernels: dict[str, Sequence[float]]
                     ) -> tuple[dict[str, float], dict[str, int]]:
        """Fit per-kernel execute costs from the recorder's kernel
        channel (``{name: chronological execute_ns}``): the first
        ``warmup`` measurements per kernel are dropped (compile noise),
        the remainder must clear ``min_samples``, and the fitted term
        is the median — the same robustness gates the wire terms get.
        Non-positive medians are discarded: a fitted compute term of
        zero would silently hide a kernel from the lane model."""
        fitted: dict[str, float] = {}
        counts: dict[str, int] = {}
        for name, values in kernels.items():
            usable = [float(v) for v in list(values)[self.warmup:]
                      if v > 0]
            if len(usable) < self.min_samples:
                continue
            med = statistics.median(usable)
            if med <= 0:
                continue
            fitted[name] = round(med, 3)
            counts[name] = len(usable)
        return fitted, counts

    def fit(self, samples: Iterable["DispatchSample"],
            kernels: dict[str, Sequence[float]] | None = None
            ) -> CalibrationProfile:
        """Produce a :class:`CalibrationProfile` for the fitter's
        topology digest. Applies every §4.4c gate; with too little
        evidence the profile is simply sparse (no fitted links and/or
        ``launch=None``) — it never invents terms to preserve the
        constants-as-fallback contract. ``kernels`` is the *separate*
        per-kernel execute channel from
        :meth:`~repro_torch.comm.telemetry.TimelineRecorder.kernel_samples`;
        keeping it apart from ``samples`` preserves the invariant that
        captured-step dispatch samples never pool with pure-comm wire
        evidence."""
        usable = self._drop_warmup(samples)
        launch, n_launch = self._fit_launch(usable)
        bw, counts = self._fit_bandwidth(usable)
        kcost, kcounts = self._fit_kernels(kernels or {})
        return CalibrationProfile(
            topology_digest=self.topology.digest(),
            link_bandwidth_gbps=bw, launch=launch,
            link_samples=counts, launch_samples=n_launch,
            kernel_cost_ns=kcost, kernel_samples=kcounts)


def modeled_sample_time_s(sample: "DispatchSample", topology: Topology,
                          profile: CalibrationProfile | None = None
                          ) -> float:
    """Re-price one recorded dispatch with the §4.4 model: closed-form
    wire time over the sample's recorded routes plus graph launch
    overhead. ``profile=None`` prices nominal topology bandwidths and
    the constant launch model; passing a profile overlays its fitted
    terms — the same substitution the live model performs, so the
    residuals this enables validate exactly what arbitration consumes."""
    bw = {k: ln.bandwidth_gbps for k, ln in topology.links.items()}
    launch = DEFAULT_LAUNCH_MODEL
    if profile is not None:
        bw.update(profile.link_bandwidth_gbps)
        if profile.launch is not None:
            launch = profile.launch
    wire, _ = _wire_model_s(sample.routes, sample.window, bw)
    overhead_ns = (launch.graph_launch_base_ns
                   + sample.num_nodes * launch.graph_launch_per_node_ns)
    return wire + overhead_ns / 1e9


def modeled_vs_measured(samples: Iterable["DispatchSample"],
                        topology: Topology,
                        profile: CalibrationProfile | None = None) -> dict:
    """Residual report: constant-model vs fitted-model relative error
    against measured dispatch time, aggregated over ``samples``.

    The drift-visibility contract behind ``session.describe()``'s
    ``calibration.residuals`` section: ``constant`` is always present;
    ``fitted`` appears when a profile is supplied. Each side reports
    ``{mean_rel_err, median_rel_err}`` of ``|modeled - measured| /
    measured`` — a fitted profile that stops beating the constants is
    visible drift."""
    const_errs, fitted_errs = [], []
    n = 0
    for s in samples:
        measured = s.measured_s
        if measured <= 0:
            continue
        n += 1
        const_t = modeled_sample_time_s(s, topology, None)
        const_errs.append(abs(const_t - measured) / measured)
        if profile is not None:
            fit_t = modeled_sample_time_s(s, topology, profile)
            fitted_errs.append(abs(fit_t - measured) / measured)

    def _agg(errs):
        if not errs:
            return None
        return {"mean_rel_err": sum(errs) / len(errs),
                "median_rel_err": statistics.median(errs)}

    return {"num_samples": n, "constant": _agg(const_errs),
            "fitted": _agg(fitted_errs) if profile is not None else None}
