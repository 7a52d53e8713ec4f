"""TLS for the REST plane (a copy of the JAX package's
``utils/ssl_config.py``): a PEM cert/key pair wraps the stdlib server
socket; configuration comes from explicit paths or the
``PIO_SSL_CERT_PATH`` / ``PIO_SSL_KEY_PATH`` env vars.
"""

from __future__ import annotations

import logging
import os
import ssl

logger = logging.getLogger(__name__)


def ssl_paths_from_env() -> tuple[str | None, str | None]:
    return (os.environ.get("PIO_SSL_CERT_PATH"), os.environ.get("PIO_SSL_KEY_PATH"))


def wrap_server_socket(httpd, cert_file: str, key_file: str) -> None:
    """Enable TLS on a bound http.server instance (before serving)."""
    context = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    context.load_cert_chain(certfile=cert_file, keyfile=key_file)
    httpd.socket = context.wrap_socket(httpd.socket, server_side=True)
    logger.info("TLS enabled (cert %s)", cert_file)


def maybe_enable_ssl(httpd, cert_file: str | None = None, key_file: str | None = None) -> bool:
    """Wrap when a cert/key pair is configured (args win over env).
    Returns whether TLS was enabled."""
    env_cert, env_key = ssl_paths_from_env()
    cert = cert_file or env_cert
    key = key_file or env_key
    if cert and key:
        wrap_server_socket(httpd, cert, key)
        return True
    return False


def client_transport() -> tuple[str, "ssl.SSLContext | None"]:
    """(scheme, ssl_context) the framework's own control-plane clients
    (``pio undeploy``'s POST /stop) use to reach its servers.

    When the env cert is configured every server speaks TLS, so clients
    return ("https", ctx) with the configured cert trusted as the CA —
    hostname checking is off because the control plane dials loopback/IPs
    with a typically self-signed cert; the cert pin is the trust anchor.
    """
    cert, key = ssl_paths_from_env()
    if not (cert and key):
        return ("http", None)
    context = ssl.create_default_context()
    context.check_hostname = False
    try:
        context.load_verify_locations(cert)
        context.verify_mode = ssl.CERT_REQUIRED
    except ssl.SSLError:
        context.verify_mode = ssl.CERT_NONE
    return ("https", context)
