"""The serving fleet's admin authorization rule.

Counterpart of ``admin_token`` and ``check_admin`` of
``paddlefleetx_tpu/core/router.py`` (``:105-158``): one shared token in
``PFX_ADMIN_TOKEN`` gates every ``/admin/*`` and ``/debug/*`` endpoint of
the serve CLI.  With the token set a request must carry ``Authorization:
Bearer <token>``; with it unset only loopback clients are let in, and the
first one logs a warning.  The router itself (replica registry, routing,
federation) is not ported; the module keeps the JAX name.
"""

from __future__ import annotations

import hmac
import os
from typing import Any, Optional, Tuple

from paddlefleetx_tpu_torch.utils.log import logger

ADMIN_TOKEN_ENV = "PFX_ADMIN_TOKEN"
_LOCAL_ONLY_WARNED = [False]  # once a process


def admin_token() -> str:
    """The fleet-shared admin token (empty = unset)."""
    return (os.environ.get(ADMIN_TOKEN_ENV) or "").strip()


def check_admin(headers: Any, client_address: Any, *,
                what: str = "/admin") -> Tuple[bool, Optional[int], Optional[str]]:
    """Authorize one admin or debug request: ``(ok, http_code, message)``.

    Token set: the request must carry ``Authorization: Bearer <token>``
    (compared in constant time), else 401.  Token unset: loopback clients
    only (403 otherwise).  ``headers`` is any ``.get()``-able mapping;
    ``client_address`` the ``(host, port)`` pair ``http.server`` gives a
    handler."""
    tok = admin_token()
    auth = str((headers.get("Authorization") if headers is not None else "") or "")
    supplied = auth[len("Bearer "):].strip() if auth.startswith("Bearer ") else ""
    if tok:
        if supplied and hmac.compare_digest(supplied, tok):
            return True, None, None
        return False, 401, f"{what} requires a valid {ADMIN_TOKEN_ENV} bearer token"
    host = str(client_address[0]) if client_address else ""
    # ::ffff:127.x is a loopback client seen through a dual-stack bind
    if host == "::1" or host.startswith("127.") or host.startswith("::ffff:127."):
        if not _LOCAL_ONLY_WARNED[0]:
            _LOCAL_ONLY_WARNED[0] = True
            logger.warning(f"{ADMIN_TOKEN_ENV} is unset: /admin and /debug endpoints are "
                           "LOCALHOST-ONLY.  Set the shared token to enable authenticated "
                           "remote admin")
        return True, None, None
    return (False, 403, f"{what} is localhost-only while {ADMIN_TOKEN_ENV} is unset; set "
            "the shared token to enable remote admin")
