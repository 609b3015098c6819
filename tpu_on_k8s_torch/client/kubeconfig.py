"""Cluster connection config resolution (reference pkg/utils/kubeconfig).

The in-memory backend needs nothing; a live GKE backend resolves its API
server + credentials the standard way: ``$KUBECONFIG`` (or ``~/.kube/config``)
when running off-cluster, the mounted service-account when in-cluster
(reference kubeconfig.go:33-56). This module does the resolution without
importing any kubernetes client — the backend consumes the returned paths.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

IN_CLUSTER_TOKEN = "/var/run/secrets/kubernetes.io/serviceaccount/token"
IN_CLUSTER_CA = "/var/run/secrets/kubernetes.io/serviceaccount/ca.crt"


@dataclass(frozen=True)
class ClusterConfig:
    mode: str                       # "in-cluster" | "kubeconfig" | "none"
    kubeconfig_path: Optional[str] = None
    api_host: Optional[str] = None
    token_path: Optional[str] = None
    ca_path: Optional[str] = None
    token: Optional[str] = None           # inline bearer (kubeconfig `token`)
    client_cert_path: Optional[str] = None
    client_key_path: Optional[str] = None


def _load_doc(path: str) -> dict:
    import yaml

    try:
        with open(path) as f:
            return yaml.safe_load(f) or {}
    except OSError:
        return {}


def _current_context(doc: dict) -> dict:
    current = doc.get("current-context")
    for ctx in doc.get("contexts", []):
        if ctx.get("name") == current:
            return ctx.get("context", {}) or {}
    return {}


def server_url(cfg: ClusterConfig) -> Optional[str]:
    """Extract the API server URL a REST backend should dial.

    kubeconfig mode resolves the current context's cluster (the clientcmd
    resolution the reference gets for free, kubeconfig.go:33-56);
    in-cluster mode uses the service-host env already captured in `cfg`.
    """
    if cfg.mode == "in-cluster":
        return cfg.api_host
    if cfg.mode == "kubeconfig" and cfg.kubeconfig_path:
        doc = _load_doc(cfg.kubeconfig_path)
        cluster_name = _current_context(doc).get("cluster")
        for c in doc.get("clusters", []):
            if cluster_name is None or c.get("name") == cluster_name:
                return c.get("cluster", {}).get("server")
    return None


def _materialize(data_b64: str, tmpdir: str, name: str) -> str:
    """Write a kubeconfig inline `*-data` credential to a private file (the
    form python's ssl wants); 0600 like kubectl's own cache files."""
    import base64

    path = os.path.join(tmpdir, name)
    with open(path, "wb") as f:
        f.write(base64.b64decode(data_b64))
    os.chmod(path, 0o600)
    return path


def credentials(cfg: ClusterConfig,
                tmpdir: Optional[str] = None) -> ClusterConfig:
    """Resolve the current context's user/cluster credentials into the
    config: bearer token (`token` / `tokenFile`), client certificate
    (`client-certificate[-data]` + `client-key[-data]`, the mTLS path), and
    the cluster CA (`certificate-authority[-data]`). In-cluster mode is
    already complete (SA token + mounted CA). Inline `*-data` entries are
    materialized under ``tmpdir`` when given, else under a lazily-created
    private tempdir removed at process exit."""
    if cfg.mode != "kubeconfig" or not cfg.kubeconfig_path:
        return cfg
    doc = _load_doc(cfg.kubeconfig_path)
    ctx = _current_context(doc)
    user: dict = {}
    for u in doc.get("users", []):
        if ctx.get("user") is None or u.get("name") == ctx.get("user"):
            user = u.get("user", {}) or {}
            break
    cluster: dict = {}
    for c in doc.get("clusters", []):
        if ctx.get("cluster") is None or c.get("name") == ctx.get("cluster"):
            cluster = c.get("cluster", {}) or {}
            break

    state = {"tmpdir": tmpdir}

    def path_or_data(path_key: str, data_key: str, src: dict,
                     fname: str) -> Optional[str]:
        if src.get(path_key):
            return src[path_key]
        if src.get(data_key):
            if state["tmpdir"] is None:
                # lazy: only create (and clean up at exit) when an inline
                # credential actually needs a file on disk
                import atexit
                import shutil
                import tempfile

                state["tmpdir"] = tempfile.mkdtemp(prefix="tpu-on-k8s-creds-")
                atexit.register(shutil.rmtree, state["tmpdir"],
                                ignore_errors=True)
            return _materialize(src[data_key], state["tmpdir"], fname)
        return None

    return ClusterConfig(
        mode=cfg.mode, kubeconfig_path=cfg.kubeconfig_path,
        api_host=cfg.api_host,
        token=user.get("token"),
        token_path=user.get("tokenFile") or cfg.token_path,
        ca_path=path_or_data("certificate-authority",
                             "certificate-authority-data", cluster,
                             "ca.crt") or cfg.ca_path,
        client_cert_path=path_or_data("client-certificate",
                                      "client-certificate-data", user,
                                      "client.crt"),
        client_key_path=path_or_data("client-key", "client-key-data", user,
                                     "client.key"),
    )


def resolve(env: Optional[dict] = None) -> ClusterConfig:
    """Kubeconfig env var → default path → in-cluster mount → none."""
    env = os.environ if env is None else env
    explicit = env.get("KUBECONFIG")
    if explicit and Path(explicit).exists():
        return ClusterConfig(mode="kubeconfig", kubeconfig_path=explicit)
    default = Path(env.get("HOME", "/root")) / ".kube" / "config"
    if default.exists():
        return ClusterConfig(mode="kubeconfig", kubeconfig_path=str(default))
    host = env.get("KUBERNETES_SERVICE_HOST")
    if host and Path(IN_CLUSTER_TOKEN).exists():
        port = env.get("KUBERNETES_SERVICE_PORT", "443")
        return ClusterConfig(mode="in-cluster", api_host=f"https://{host}:{port}",
                             token_path=IN_CLUSTER_TOKEN, ca_path=IN_CLUSTER_CA)
    return ClusterConfig(mode="none")
