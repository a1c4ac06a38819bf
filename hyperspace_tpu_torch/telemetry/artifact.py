"""Canonical bench-artifact schema: ONE versioned shape for every
benchmark round, the JAX package's schema (`SCHEMA_VERSION` 1, the same
`REQUIRED_FIELDS`), so an artifact written by either package validates,
loads and diffs in the other.

- `make_artifact(...)` — the ONE emitter a bench script routes its
  final JSON through. It stamps `schema_version`, the bench script's name, the
  platform ("gpu" or "cpu") with the card's kind and power limit, and
  ALWAYS attaches the process-wide digests (`process_metrics`,
  `memory`, `transfer`, `device_cost`, `tenant_cost`,
  `critical_path`), so no round can miss the telemetry the differ
  attributes from.
- `query_metrics_block(qm)` — the per-query telemetry block: the
  compact `summary()` digest next to the FULL `to_dict()` operator
  tree (`"tree"`), which is what `diff.py` aligns node-by-node.
- `load(path)` / `migrate(doc)` — read any artifact, unwrapping the
  command envelope; legacy (pre-schema) documents raise
  `LegacyArtifactError` unless migration is requested. Migration is
  lossless: every legacy field is preserved, `schema_version` is
  stamped, and `"legacy": true` records that the telemetry sections
  are absent-by-history rather than absent-by-bug.

Run `python -m hyperspace_tpu_torch.telemetry.artifact migrate FILE...`
to migrate artifacts in place (the command envelope, when present, is
preserved and its `parsed` payload migrated).
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

SCHEMA_VERSION = 1

# A canonical artifact MUST carry these; `validate()` reports what is
# missing and the regression gate refuses to gate without them.
REQUIRED_FIELDS = ("schema_version", "metric", "value", "vs_baseline",
                   "process_metrics")


class LegacyArtifactError(Exception):
    """Raised when a pre-schema artifact is loaded without asking for
    migration — gating or diffing it silently would compare shapes
    that do not mean the same thing."""

    def __init__(self, path: str, missing: List[str]):
        self.path = path
        self.missing = missing
        super().__init__(
            f"{path}: legacy-schema bench artifact (missing "
            f"{', '.join(missing)}). Re-run the bench script (it now "
            "emits the canonical schema), or migrate in place: "
            "python -m hyperspace_tpu_torch.telemetry.artifact migrate "
            f"{path}")


def transfer_digest() -> dict:
    """Process-lifetime digest of the pipelined transfer engine's link
    counters — embedded by every bench script so the overlap the engine
    claims is a committed number, not an assumption."""
    from hyperspace_tpu_torch.telemetry import registry as _registry

    c = _registry.get_registry().counters_dict()
    return {
        "h2d_bytes": int(c.get("link.h2d.bytes", 0)),
        "h2d_seconds": round(c.get("link.h2d.seconds", 0.0), 3),
        "h2d_chunks": int(c.get("link.h2d.chunks", 0)),
        "h2d_transfers": int(c.get("link.h2d.transfers", 0)),
        "d2h_bytes": int(c.get("link.d2h.bytes", 0)),
        "d2h_seconds": round(c.get("link.d2h.seconds", 0.0), 3),
        "d2h_chunks": int(c.get("link.d2h.chunks", 0)),
        "d2h_prefetch_errors": int(c.get("link.d2h.prefetch_errors", 0)),
        "overlap_saved_seconds": round(
            c.get("transfer.overlap_saved_seconds", 0.0), 3),
    }


def segments_digest() -> dict:
    """Process-lifetime digest of the device segment cache
    (`io/segcache.py`) — hit/miss/fill/eviction counts and current
    residency. Bench scripts embed it (with per-rung warm deltas) so
    "repeat queries are link-free" is a committed, gateable number:
    `scripts/bench_regress.py`'s warm-rung gate reads this block."""
    from hyperspace_tpu_torch.telemetry import registry as _registry

    reg = _registry.get_registry()
    c = reg.counters_dict()
    return {
        "hits": int(c.get("cache.segments.hits", 0)),
        "misses": int(c.get("cache.segments.misses", 0)),
        "fills": int(c.get("cache.segments.fills", 0)),
        "evictions": int(c.get("cache.segments.evictions", 0)),
        "fill_bytes": int(c.get("transfer.fill.bytes", 0)),
        "fill_chunks": int(c.get("transfer.fill.chunks", 0)),
        "bytes_held": int(reg.gauge("cache.segments.bytes_held").value),
        "entries": int(reg.gauge("cache.segments.entries").value),
        "pins": int(reg.gauge("cache.segments.pins").value),
    }


def device_cost_digest() -> dict:
    """Process-lifetime roofline digest: modeled device cost (each
    entry point's cost function, charged per call by
    `instrumented_device`) next to the measured device seconds, plus
    the per-entry-point cost memo (the last call's cost) — so a round
    carries whether the work was device-bound or overhead-bound, not
    just how long it took."""
    from hyperspace_tpu_torch.telemetry import compilation
    from hyperspace_tpu_torch.telemetry import registry as _registry

    compilation.resolve_pending()
    c = _registry.get_registry().counters_dict()
    flops = float(c.get("device.flops", 0.0))
    nbytes = float(c.get("device.bytes_accessed", 0.0))
    disp = float(c.get("device.dispatch.seconds", 0.0))
    return {
        "flops": round(flops, 1),
        "bytes_accessed": round(nbytes, 1),
        "dispatch_seconds": round(disp, 6),
        "intensity_flops_per_byte": (round(flops / nbytes, 4)
                                     if nbytes else None),
        "achieved_flops_per_s": (round(flops / disp, 1)
                                 if disp > 0 else None),
        "per_entry_point": {
            name: {"flops": round(f, 1), "bytes_accessed": round(b, 1)}
            for name, (f, b)
            in sorted(compilation.entry_point_costs().items())},
    }


def tenant_cost_digest() -> dict:
    """Per-tenant chargeback digest: each known tenant's billed device
    cost, link bytes, and cache fills (`telemetry.tenant_digest()`),
    plus the exactness check — per-tenant sums vs the global counters.
    Attached to every artifact so a committed round records WHO spent
    the device-seconds, not just that they were spent."""
    from hyperspace_tpu_torch import telemetry

    telemetry.compilation.resolve_pending()
    usage = telemetry.tenant_digest()
    # Unrounded, like the digest: the sums are compared bit for bit.
    counters = telemetry.get_registry().series_snapshot()["counters"]
    totals = {name: sum(u.get(name, 0) for u in usage.values())
              for name in telemetry.TENANT_CHARGE_COUNTERS}
    global_ = {name: counters.get(name, 0)
               for name in telemetry.TENANT_CHARGE_COUNTERS}
    return {
        "tenants": usage,
        "totals": {k: round(v, 6) if isinstance(v, float) else v
                   for k, v in totals.items()},
        "global": {k: round(v, 6) if isinstance(v, float) else v
                   for k, v in global_.items()},
        "exact": all(abs(totals[n] - global_[n])
                     <= 1e-9 * max(1.0, abs(global_[n]))
                     for n in totals),
    }


def critpath_digest() -> dict:
    """Process-lifetime latency anatomy: total seconds attributed to
    each critical-path segment across every stamped query
    (`telemetry/critical_path.py`), their share of total query wall,
    and the dominant segment. Attached to every artifact so a
    committed round records WHERE the wall went, not just how long it
    was."""
    from hyperspace_tpu_torch.telemetry import critical_path
    from hyperspace_tpu_torch.telemetry import registry as _registry

    c = _registry.get_registry().counters_dict()
    wall = float(c.get("critpath.wall.seconds", 0.0))
    seconds = {seg: round(float(
        c.get(f"critpath.{seg}.seconds", 0.0)), 6)
        for seg in critical_path.SEGMENTS}
    out = {
        "queries": int(c.get("critpath.queries", 0)),
        "wall_seconds": round(wall, 6),
        "seconds": seconds,
        "shares": {seg: (round(v / wall, 4) if wall else 0.0)
                   for seg, v in seconds.items()},
        "overlap_seconds": round(float(
            c.get("critpath.overlap.seconds", 0.0)), 6),
    }
    out["dominant"] = (max(seconds, key=seconds.get)
                       if wall else None)
    return out


def _nvidia_smi() -> Optional[List[str]]:
    """[name, power limit] of the first card as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them, or
    None where the tool is absent or fails — never a made-up value."""
    import shutil
    import subprocess
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        out = subprocess.run(
            [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = [ln for ln in out.splitlines() if ln.strip()]
    if not lines:
        return None
    parts = [p.strip() for p in lines[0].split(",")]
    return parts if len(parts) == 2 else None


def device_digest(device=None) -> dict:
    """{platform, device_kind, power_limit} of the device a round ran
    on: platform "gpu" for a CUDA device, else "cpu"; the kind and the
    power limit come from `nvidia-smi` on a card (None where it is
    absent) and are None on the CPU."""
    kind = str(device).split(":")[0] if device is not None else "cpu"
    if kind != "cuda":
        return {"platform": "cpu", "device_kind": None,
                "power_limit": None}
    smi = _nvidia_smi()
    return {"platform": "gpu",
            "device_kind": smi[0] if smi else None,
            "power_limit": smi[1] if smi else None}


def query_metrics_block(qm) -> dict:
    """Per-query telemetry block: `summary()` (the compact rollup
    earlier rounds embedded) plus the full `to_dict()` operator tree
    the differ aligns node-by-node. `qm` may be None (e.g. a lane that
    never executed under a recorder) — both keys are then None so the
    artifact shape stays diffable."""
    if qm is None:
        return {"metrics": None, "tree": None}
    return {"metrics": qm.summary(), "tree": qm.to_dict()}


def make_artifact(*, driver: str, metric: str, value, unit: str,
                  vs_baseline, queries: Optional[Dict[str, dict]] = None,
                  rungs: Optional[Dict[str, dict]] = None,
                  extra: Optional[dict] = None, device=None) -> dict:
    """Assemble the canonical artifact document. `device` is the device
    the round's tensors lived on (a `torch.device` or its name); it sets
    `platform` ("gpu" for CUDA, "cpu" otherwise) and, on a card, its
    kind and power limit. The process-wide digests are attached HERE,
    unconditionally — a bench script cannot emit a canonical artifact that
    lacks them."""
    from hyperspace_tpu_torch import telemetry

    doc: dict = {
        "schema_version": SCHEMA_VERSION,
        "driver": driver,
        "generated_at": round(time.time(), 3),
        "metric": metric,
        "value": value,
        "unit": unit,
        "vs_baseline": vs_baseline,
    }
    doc.update(device_digest(device))
    if extra:
        doc.update(extra)
    if queries is not None:
        doc["queries"] = queries
    if rungs is not None:
        doc["rungs"] = rungs
    doc["transfer"] = transfer_digest()
    doc["process_metrics"] = telemetry.get_registry().counters_dict()
    doc["memory"] = telemetry.memory.artifact_section()
    doc["device_cost"] = device_cost_digest()
    doc["tenant_cost"] = tenant_cost_digest()
    doc["critical_path"] = critpath_digest()
    return doc


# ---------------------------------------------------------------------------
# Loading / validation / migration
# ---------------------------------------------------------------------------


def unwrap(doc: dict) -> dict:
    """Strip a runner's `{n, cmd, rc, tail, parsed}` command
    envelope, when present (a runner wraps whatever the bench process
    printed; the payload is what the schema governs)."""
    if isinstance(doc, dict) and isinstance(doc.get("parsed"), dict) \
            and "cmd" in doc:
        return doc["parsed"]
    return doc


def validate(doc: dict) -> List[str]:
    """Missing required canonical fields (empty list = canonical)."""
    doc = unwrap(doc)
    return [f for f in REQUIRED_FIELDS if f not in doc]


def is_canonical(doc: dict) -> bool:
    return not validate(doc)


def migrate(doc: dict, source: str = "") -> dict:
    """Upgrade a legacy document to the canonical schema IN MEMORY,
    losslessly: every field the legacy round committed is preserved,
    `schema_version` is stamped, telemetry sections the round never
    recorded are filled with empty dicts, and `"legacy": true` marks
    that those sections are absent-by-history. Canonical input is
    returned unchanged."""
    doc = unwrap(doc)
    if is_canonical(doc):
        return doc
    out = dict(doc)
    out["schema_version"] = SCHEMA_VERSION
    out["legacy"] = True
    if source:
        out["migrated_from"] = source
    out.setdefault("process_metrics", {})
    # Headline fields a script-less legacy blob (e.g. the pre-r06
    # MULTICHIP `{n_devices, rc, ok}` smoke checks) never carried:
    # present-but-null keeps the shape canonical while every gate
    # treats the non-numeric values as not-gateable history.
    out.setdefault("metric", "legacy")
    out.setdefault("value", None)
    out.setdefault("vs_baseline", None)
    return out


def load(path: str, migrate_legacy: bool = False) -> dict:
    """Load a committed artifact (command envelope unwrapped). Legacy
    documents raise `LegacyArtifactError` unless `migrate_legacy`."""
    with open(path) as f:
        doc = json.load(f)
    doc = unwrap(doc)
    if not isinstance(doc, dict):
        raise LegacyArtifactError(path, list(REQUIRED_FIELDS))
    missing = validate(doc)
    if missing:
        if not migrate_legacy:
            raise LegacyArtifactError(path, missing)
        doc = migrate(doc, source=path)
    return doc


def migrate_file(path: str) -> bool:
    """Migrate a committed artifact file in place, preserving the
    command envelope when present. Returns True if the file changed."""
    with open(path) as f:
        outer = json.load(f)
    inner = unwrap(outer)
    if is_canonical(inner):
        return False
    migrated = migrate(inner, source="legacy "
                       + (inner.get("metric") or "artifact"))
    if inner is not outer:
        outer = dict(outer)
        outer["parsed"] = migrated
    else:
        outer = migrated
    with open(path, "w") as f:
        json.dump(outer, f)
        f.write("\n")
    return True


def _main(argv: List[str]) -> int:
    if len(argv) >= 2 and argv[0] == "migrate":
        for path in argv[1:]:
            changed = migrate_file(path)
            print(f"{path}: {'migrated' if changed else 'already canonical'}")
        return 0
    print("usage: python -m hyperspace_tpu_torch.telemetry.artifact "
          "migrate FILE...")
    return 2


if __name__ == "__main__":
    import sys
    sys.exit(_main(sys.argv[1:]))
