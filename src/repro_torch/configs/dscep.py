"""DSCEP deployment presets: the paper's own "architecture".

Where the LM configs describe neural stacks, these presets describe SCEP
pipeline deployments: window geometry (paper §4.4: "window size is a
maximum of 1000 RDF triples"), engine capacities, KB-access method and the
execution mode, with the reference's values.  ``build_runtime`` registers
a query in a :class:`~repro_torch.core.session.Session` deploying a
preset, as ``launch/dscep_run.py`` deploys.

A preset holds its settings without a device: an
:class:`~repro_torch.core.session.ExecutionConfig` on ``"cuda"`` cannot be
built where no card is visible, so :meth:`DSCEPDeployment.config` builds
one for the device asked for (the card by default).  The presets keep the
reference's ``fuse_compaction=False`` (its default): scan joins run
unfused, through the match-matrix kernel.
"""
from __future__ import annotations

import dataclasses
import types
from typing import Any, Dict, Mapping

from ..core.session import ExecutionConfig, Session

_PAPER_CAPS = dict(window_capacity=1000, max_windows=8, bind_cap=4096,
                   scan_cap=1024, out_cap=4096, fuse_compaction=False)


@dataclasses.dataclass(frozen=True)
class DSCEPDeployment:
    name: str
    settings: Mapping[str, Any]        # ExecutionConfig fields but device
    description: str = ""

    def __post_init__(self):
        object.__setattr__(self, "settings",
                           types.MappingProxyType(dict(self.settings)))
        self.config("cpu")              # validates the settings

    def config(self, device: str = "cuda") -> ExecutionConfig:
        """The preset as an :class:`ExecutionConfig` on ``device``."""
        return ExecutionConfig(device=device, **self.settings)

    @property
    def runtime(self):
        """The engine-level slice (a device-free ``RuntimeConfig``)."""
        return self.config("cpu").runtime_config()

    @property
    def decomposed(self) -> bool:
        return self.settings.get("mode", "single_program") != "monolithic"


_PRESETS: Dict[str, DSCEPDeployment] = {}


def register_deployment(d: DSCEPDeployment) -> DSCEPDeployment:
    _PRESETS[d.name] = d
    return d


# the paper's evaluation setup (§4.4): 1000-triple windows, scan KB access
register_deployment(DSCEPDeployment(
    "paper-eval", dict(mode="single_program", kb_method="scan", **_PAPER_CAPS),
    "Paper §4.4 settings: 1000-triple windows, C-SPARQL-style "
    "attached-KB scans, automatic Fig. 4 decomposition."))

# SERVICE-style endpoint access (the paper's second measured method)
register_deployment(DSCEPDeployment(
    "paper-eval-subquery",
    dict(mode="single_program", kb_method="probe", **_PAPER_CAPS),
    "Paper §4.4 settings with SPARQL-subquery (indexed endpoint) KB "
    "access."))

# cost-based KB access: each operator's used-KB slice is profiled at build
# time and every KB join picks probe (with a derived k_max) or scan
register_deployment(DSCEPDeployment(
    "paper-eval-auto",
    dict(mode="single_program", kb_method="auto", **_PAPER_CAPS),
    "Paper §4.4 settings with cost-based per-join KB access (probe where "
    "anchored fan-out is small, scan otherwise) and selectivity-ordered "
    "joins."))

# container-scale smoke (tests/examples)
register_deployment(DSCEPDeployment(
    "smoke",
    dict(mode="single_program", window_capacity=128, max_windows=4,
         bind_cap=1024, scan_cap=128, out_cap=1024, kb_method="auto",
         fuse_compaction=False),
    "Reduced capacities for CPU smoke runs."))

# monolithic baseline (paper Table 2); kb_method the ExecutionConfig default
register_deployment(DSCEPDeployment(
    "monolithic", dict(mode="monolithic", kb_method="scan", **_PAPER_CAPS),
    "Single-operator execution against the full KB (Table 2 baseline)."))

# heterogeneous windows: each registered .rq's RANGE clause is its geometry
register_deployment(DSCEPDeployment(
    "per-query-windows",
    dict(mode="single_program", kb_method="auto", window_from_query=True,
         **_PAPER_CAPS),
    "One Session, many queries: each registered query's [RANGE TRIPLES n "
    "STEP m] clause drives its own window geometry (window_capacity is "
    "only the default for queries without a RANGE clause)."))

# streaming dataflow deployment (operators over device channels)
register_deployment(DSCEPDeployment(
    "pipelined",
    dict(mode="pipelined", kb_method="auto", channel_capacity=2,
         **_PAPER_CAPS),
    "Per-operator steps over bounded device channels, software-pipelined "
    "schedule (2 chunks in flight)."))


def get_deployment(name: str) -> DSCEPDeployment:
    return _PRESETS[name]


def deployments() -> Dict[str, DSCEPDeployment]:
    return dict(_PRESETS)


def build_runtime(preset: str, query, kb, vocab, mesh=None,
                  device: str = "cuda"):
    """Register ``query`` in a Session deploying ``preset`` on ``device``
    (with ``mesh=``, its windows sharded over the mesh's data axis).
    Returns the :class:`~repro_torch.core.session.RegisteredQuery`, the
    drive handle (``process_chunk`` / ``run`` / ``stream``) in every
    mode."""
    cfg = get_deployment(preset).config(device)
    if mesh is not None:
        cfg = cfg.replace(mesh=mesh)
    return Session(cfg, vocab=vocab, kb=kb).register(query)
