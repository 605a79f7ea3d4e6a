"""Findings, reports, and the reviewed allowlist (DESIGN.md §15).

A copy of ``repro.analysis.findings`` (pure Python; the port imports
nothing of the JAX package), with the port's contracts.  A finding is
one contract violation pinned to a source location.  The allowlist
holds *reviewed* violations — each line is a key that an engineer
looked at and signed off on, with its reason in a comment (e.g. a host
sync that a named ROADMAP item removes).
"""

from __future__ import annotations

import dataclasses
import fnmatch
import json
import os
from typing import Any, Dict, List, Optional, Tuple

CONTRACTS = ("host-sync", "alloc-budget", "smem", "lint")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One contract violation at one source location."""

    contract: str          # one of CONTRACTS (lint may add a :sub tag)
    entry: str             # registered entry-point name (or fixture name)
    location: str          # "path/to/file.py:123" best-effort
    message: str           # human-readable, includes the numbers
    details: Dict[str, Any] = dataclasses.field(default_factory=dict)
    severity: str = "error"    # "error" gates CI; "info" is advisory

    def key(self) -> str:
        """Stable allowlist key: contract, entry, and the location
        stripped to ``basename:line`` so the key survives repo moves."""
        loc = self.location
        if ":" in loc:
            path, _, line = loc.rpartition(":")
            loc = f"{os.path.basename(path)}:{line}"
        else:
            loc = os.path.basename(loc) if loc else "-"
        return f"{self.contract} {self.entry} {loc}"

    def to_json(self) -> Dict[str, Any]:
        return {
            "contract": self.contract,
            "entry": self.entry,
            "location": self.location,
            "message": self.message,
            "severity": self.severity,
            "details": self.details,
            "key": self.key(),
        }


def load_allowlist(path: Optional[str]) -> List[str]:
    """Read allowlist patterns: one per line, ``#`` comments, blank
    lines skipped.  Each pattern is matched (fnmatch) against
    ``Finding.key()`` — so ``lint * fused_lookup.py:*`` allows every
    lint finding in that file, and an exact key allows one line."""
    if not path or not os.path.exists(path):
        return []
    pats: List[str] = []
    with open(path) as fh:
        for raw in fh:
            line = raw.split("#", 1)[0].strip()
            if line:
                pats.append(line)
    return pats


def _allowed(finding: Finding, patterns: List[str]) -> bool:
    key = finding.key()
    return any(fnmatch.fnmatch(key, p) for p in patterns)


class Report:
    """Collects findings, splits them against the allowlist, and
    renders the CI-facing summary."""

    def __init__(self, allowlist: Optional[List[str]] = None):
        self.allowlist = list(allowlist or [])
        self.findings: List[Finding] = []
        self.checked: List[Tuple[str, str]] = []   # (entry, contract) passes
        self._seen: set = set()

    def add(self, finding: Finding) -> None:
        # dedupe across traces: the same defect shows up once per
        # captured signature of the same entry point
        dedup = (finding.contract, finding.entry, finding.location,
                 finding.message.split(":", 1)[0])
        if dedup in self._seen:
            return
        self._seen.add(dedup)
        self.findings.append(finding)

    def note_pass(self, entry: str, contract: str) -> None:
        self.checked.append((entry, contract))

    # ---------------------------------------------------------- queries
    def blocking(self) -> List[Finding]:
        return [f for f in self.findings
                if f.severity == "error" and not _allowed(f, self.allowlist)]

    def allowed(self) -> List[Finding]:
        return [f for f in self.findings if _allowed(f, self.allowlist)]

    def advisory(self) -> List[Finding]:
        return [f for f in self.findings
                if f.severity != "error" and not _allowed(f, self.allowlist)]

    @property
    def ok(self) -> bool:
        return not self.blocking()

    # -------------------------------------------------------- rendering
    def render(self) -> str:
        lines: List[str] = []
        by_entry: Dict[str, set] = {}
        for entry, contract in self.checked:
            by_entry.setdefault(entry, set()).add(contract)
        for entry in sorted(by_entry):
            contracts = ", ".join(sorted(by_entry[entry]))
            lines.append(f"  pass  {entry}  [{contracts}]")
        for f in self.advisory():
            lines.append(f"  info  [{f.contract}] {f.entry} @ {f.location}")
            lines.append(f"        {f.message}")
        for f in self.allowed():
            lines.append(f"  allow [{f.contract}] {f.entry} @ {f.location}"
                         f"  (allowlisted)")
        blocking = self.blocking()
        for f in blocking:
            lines.append(f"  FAIL  [{f.contract}] {f.entry} @ {f.location}")
            lines.append(f"        {f.message}")
            lines.append(f"        allowlist key: {f.key()}")
        n_pass = len(set(self.checked))
        tail = (f"{n_pass} contract checks passed, "
                f"{len(self.allowed())} allowlisted, "
                f"{len(self.advisory())} advisory, "
                f"{len(blocking)} blocking")
        lines.append(("FAIL: " if blocking else "OK: ") + tail)
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps({
            "ok": self.ok,
            "checked": [{"entry": e, "contract": c} for e, c in self.checked],
            "findings": [f.to_json() for f in self.findings],
            "blocking": [f.to_json() for f in self.blocking()],
            "allowlist": self.allowlist,
        }, indent=2)
