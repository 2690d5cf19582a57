"""Speculative decoding config (``Generation.speculative``).

Only the config parse of ``paddlefleetx_tpu/ops/speculative.py`` is
ported so far: the section is read and validated, and a request for
speculation (``draft_k > 0``) fails loudly instead of being served by
the plain loop.  The drafter and the verify loop (``decode_step_spec``
over the paged engine) are a later slice of the port.
"""

from __future__ import annotations

from typing import Optional


def spec_config_from(section) -> Optional[dict]:
    """Parse a ``Generation.speculative`` section.  Returns None when
    speculation is off (absent section or ``draft_k`` 0); raises
    ``NotImplementedError`` for ``draft_k > 0`` and ``ValueError`` for a
    negative one.  ``kv_dtype`` in the same section routes to the cache
    allocation (``ops/decode_attention.kv_cache_dtype``), not here."""
    section = dict(section or {})
    draft_k = int(section.get("draft_k", 0) or 0)
    if draft_k < 0:
        raise ValueError(f"draft_k must be >= 0, got {draft_k}")
    if draft_k == 0:
        return None
    raise NotImplementedError(
        f"speculative decoding (Generation.speculative.draft_k={draft_k}) is "
        "not ported to the PyTorch port yet (the paged engine's verify loop "
        "is a later slice)"
    )
