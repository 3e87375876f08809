"""Small stand-ins for a cell's configuration and traffic, for CPU runs."""
import dataclasses

from pbench.cell import _arch_config
from pbench.manifest import Manifest
from pbench.traffic import Traffic

MANIFEST = Manifest.load()


def tiny(workload: str, f32: bool = False, **traffic):
    """The cell's configuration at its ``.tiny()`` size and its traffic with
    96-160-token contexts, 8-token questions and at most 6-token answers."""
    w = MANIFEST.workload(workload)
    cfg = _arch_config(MANIFEST.config(w["config"])["arch"]).tiny()
    if f32:
        cfg = dataclasses.replace(cfg, dtype="float32")
    t = Traffic.load(MANIFEST.traffic_path(w["traffic"]))
    sizes = dict(ctx_min=96, ctx_max=160, ctx_step=16, chunk_tokens=48, calibration_tokens=64, question_tokens=8,
                 answer_tokens=min(t.answer_tokens, 6))
    sizes.update(traffic)
    return dataclasses.asdict(cfg), dataclasses.replace(t, **sizes)
