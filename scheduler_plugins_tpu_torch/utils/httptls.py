"""Shared HTTPS client plumbing (port of `scheduler_plugins_tpu.utils.httptls`)
for every apiserver-facing component (reflector agent, binding POSTs,
lease elector): one place for the CA-trust / skip-verify policy so a TLS
fix cannot silently diverge between the three callers."""

from __future__ import annotations

import ssl
from typing import Optional


def ssl_context(url: str, ca_file: Optional[str] = None,
                insecure_skip_verify: bool = False):
    """Default-verifying SSL context for an https URL (None for http).
    `ca_file` trusts a private CA (in-cluster: the serviceaccount ca.crt)
    without disabling verification; `insecure_skip_verify` is the
    public-API equivalent of the old private _create_unverified_context."""
    if not url.startswith("https"):
        return None
    ctx = ssl.create_default_context(cafile=ca_file)
    if insecure_skip_verify:
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    return ctx
