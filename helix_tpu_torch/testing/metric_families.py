"""The ``/metrics`` families the port mints, with their type and label keys.

``metric_families.json`` beside this module lists every family the
port's ``OpenAIServer`` can emit, as ``{name: [type, [label keys]]}``
(label keys sorted, a histogram's ``le`` left out).  The CPU tests hold
the list to the reference's ``_collect_metrics`` shape and to the port's
own scrape (``tests/test_torch_obs.py``); ``chip_smoke.py`` holds the
card's scrape to it with ``check_scrape``.  The names live in JSON, not
in code, so each family keeps its one minting module.
"""

from __future__ import annotations

import json
import os
import re

from helix_tpu_torch.obs.metrics import validate_metric_name

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "metric_families.json")


_SAMPLE_RE = re.compile(
    r"([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? "
    r"(NaN|[+-]Inf|[-+]?[0-9.]+(?:[eE][-+]?[0-9]+)?)"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"(,|$)')
_HISTOGRAM_SUFFIXES = ("_bucket", "_sum", "_count")


def parse_exposition(text: str) -> dict:
    """Parse Prometheus text exposition strictly: ``{family: (type,
    label keys)}``, the keys sorted and without a histogram's ``le``.
    Raises ``ValueError`` naming the first line that does not parse, a
    sample before its family's TYPE comment or a family typed twice."""
    fams: dict = {}
    for n, line in enumerate(text.splitlines(), 1):
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(" ")
            if parts[:2] == ["#", "HELP"]:
                continue
            if parts[:2] != ["#", "TYPE"] or len(parts) != 4 or parts[3] \
                    not in ("counter", "gauge", "histogram", "untyped"):
                raise ValueError(f"line {n}: bad comment line {line!r}")
            validate_metric_name(parts[2])
            if parts[2] in fams:
                raise ValueError(f"line {n}: {parts[2]} typed twice")
            fams[parts[2]] = [parts[3], set()]
            continue
        m = _SAMPLE_RE.fullmatch(line)
        if m is None:
            raise ValueError(f"line {n}: not a sample {line!r}")
        name, raw, _value = m.groups()
        keys = set()
        pos = 0
        while raw and pos < len(raw):
            lm = _LABEL_RE.match(raw, pos)
            if lm is None:
                raise ValueError(f"line {n}: bad labels {raw!r}")
            keys.add(lm.group(1))
            pos = lm.end()
        fam = name
        if fam not in fams:
            for suffix in _HISTOGRAM_SUFFIXES:
                base = name[: -len(suffix)]
                if name.endswith(suffix) and fams.get(base, [""])[0] \
                        == "histogram":
                    fam = base
                    break
        if fam not in fams:
            raise ValueError(f"line {n}: sample of untyped family {name}")
        fams[fam][1] |= keys - {"le"}
    return {k: (kind, tuple(sorted(keys))) for k, (kind, keys) in
            fams.items()}


def metric_families() -> dict:
    """``{name: (type, label keys)}`` from the committed list."""
    with open(PATH) as f:
        doc = json.load(f)
    return {name: (kind, tuple(keys)) for name, (kind, keys) in doc.items()}


def check_scrape(text: str) -> list:
    """Problems of one scrape against the list: a line that does not
    parse, a family the list does not hold, or one whose type or label
    keys differ from the list's (empty: the scrape is clean)."""
    try:
        got = parse_exposition(text)
    except ValueError as e:
        return [str(e)]
    want = metric_families()
    out = []
    for name, shape in sorted(got.items()):
        if name not in want:
            out.append(f"{name}: not in the family list")
        elif shape != want[name]:
            out.append(f"{name}: {shape} != listed {want[name]}")
    return out
