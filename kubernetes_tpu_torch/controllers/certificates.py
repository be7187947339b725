"""Certificates controller — CSR approval plumbing + the signing controller.

Reference: ``pkg/controller/certificates/`` (``signer/signer.go``: watch
CertificateSigningRequests, sign the ones carrying an Approved condition
with the cluster CA, write status.certificate; ``approver/`` auto-approves
self-node client certs — kept manual here, like kubectl certificate
approve). Real X.509: the controller holds a self-signed cluster CA and
issues certificates honoring the CSR's subject and requested usages.
"""

from __future__ import annotations

import base64
import datetime

from kubernetes_tpu_torch.utils.clock import rfc3339_now
from kubernetes_tpu_torch.client.clientset import ApiError
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.controllers.base import Controller

SIGNER_KUBE_APISERVER_CLIENT = "kubernetes.io/kube-apiserver-client"

# ``cryptography`` is an optional dependency: every X.509 operation below
# imports it lazily, and components that can run without a signer (the
# controller manager, tests) consult this flag instead of crashing on
# construction. Skip-marked tests key off it too.
try:
    import cryptography  # noqa: F401
    HAVE_CRYPTOGRAPHY = True
except ImportError:  # pragma: no cover - depends on environment
    HAVE_CRYPTOGRAPHY = False

_USAGE_MAP = {  # CSR usages -> x509 KeyUsage flag names
    "digital signature": "digital_signature",
    "key encipherment": "key_encipherment",
}


def generate_ca(common_name: str = "ktpu-cluster-ca"):
    """-> (ca_cert, ca_key) — the cluster CA the signer issues from."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID
    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder()
            .subject_name(name).issuer_name(name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + datetime.timedelta(days=3650))
            .add_extension(x509.BasicConstraints(ca=True, path_length=None),
                           critical=True)
            .sign(key, hashes.SHA256()))
    return cert, key


def make_csr_pem(common_name: str, organizations: tuple = ()) -> tuple:
    """Test/client helper: -> (csr_pem bytes, private key)."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID
    key = ec.generate_private_key(ec.SECP256R1())
    attrs = [x509.NameAttribute(NameOID.COMMON_NAME, common_name)]
    attrs += [x509.NameAttribute(NameOID.ORGANIZATION_NAME, o)
              for o in organizations]
    csr = (x509.CertificateSigningRequestBuilder()
           .subject_name(x509.Name(attrs))
           .sign(key, hashes.SHA256()))
    return csr.public_bytes(serialization.Encoding.PEM), key


def _is_approved(csr: dict) -> bool:
    for cond in (csr.get("status") or {}).get("conditions") or []:
        if cond.get("type") == "Approved" and cond.get("status", "True") \
                in ("True", True):
            return True
    return False


def _is_denied(csr: dict) -> bool:
    return any(c.get("type") == "Denied"
               for c in (csr.get("status") or {}).get("conditions") or [])


def _has_failed(csr: dict) -> bool:
    return any(c.get("type") == "Failed"
               for c in (csr.get("status") or {}).get("conditions") or [])


class CSRSigningController(Controller):
    """Sign approved CSRs with the cluster CA (signer/signer.go)."""

    name = "csrsigning"
    workers = 1

    def __init__(self, client, ca=None, ttl_days: int = 365):
        super().__init__(client)
        self.ca_cert, self.ca_key = ca if ca is not None else generate_ca()
        self.ttl_days = ttl_days

    def ca_pem(self) -> bytes:
        from cryptography.hazmat.primitives import serialization
        return self.ca_cert.public_bytes(serialization.Encoding.PEM)

    def register(self, factory: InformerFactory) -> None:
        self.csr_informer = factory.informer("certificatesigningrequests",
                                             None)
        self.csr_informer.add_event_handler(
            lambda t, obj, old: self.enqueue(obj))

    def sync(self, key: str) -> None:
        res = self.client.resource("certificatesigningrequests", None)
        try:
            csr = res.get(key)
        except ApiError as e:
            if e.code == 404:
                return
            raise
        status = csr.get("status") or {}
        if status.get("certificate") or _is_denied(csr) \
                or _has_failed(csr) or not _is_approved(csr):
            # a recorded Failed condition is terminal: retrying an
            # unsignable request would hot-loop (each status write
            # re-enqueues via the watch) while growing conditions forever
            return
        spec = csr.get("spec") or {}
        if spec.get("signerName", SIGNER_KUBE_APISERVER_CLIENT) \
                != SIGNER_KUBE_APISERVER_CLIENT:
            return  # another signer's jurisdiction
        try:
            pem = base64.b64decode(spec.get("request", ""))
            cert_pem = self._sign(pem, spec.get("usages") or [])
        except Exception as e:
            status.setdefault("conditions", []).append(
                {"type": "Failed", "status": "True",
                 "reason": "SigningError", "message": str(e)})
            csr["status"] = status
            self._write_status(res, csr)
            return
        status["certificate"] = base64.b64encode(cert_pem).decode()
        csr["status"] = status
        self._write_status(res, csr)

    def _write_status(self, res, csr) -> None:
        try:
            res.update_status(csr)
        except ApiError as e:
            if e.code not in (404, 409):  # 409: raced; watch re-enqueues
                raise

    def _sign(self, csr_pem: bytes, usages: list) -> bytes:
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization
        req = x509.load_pem_x509_csr(csr_pem)
        if not req.is_signature_valid:
            raise ValueError("CSR signature invalid")
        now = datetime.datetime.now(datetime.timezone.utc)
        ku = {name: False for name in (
            "digital_signature", "content_commitment", "key_encipherment",
            "data_encipherment", "key_agreement", "key_cert_sign",
            "crl_sign", "encipher_only", "decipher_only")}
        for u in usages or ["digital signature", "key encipherment"]:
            flag = _USAGE_MAP.get(str(u).lower())
            if flag:
                ku[flag] = True
        if not any(ku.values()):
            ku["digital_signature"] = True
        cert = (x509.CertificateBuilder()
                .subject_name(req.subject)
                .issuer_name(self.ca_cert.subject)
                .public_key(req.public_key())
                .serial_number(x509.random_serial_number())
                .not_valid_before(now - datetime.timedelta(minutes=5))
                .not_valid_after(now + datetime.timedelta(days=self.ttl_days))
                .add_extension(x509.BasicConstraints(ca=False,
                                                     path_length=None),
                               critical=True)
                .add_extension(x509.KeyUsage(**ku), critical=True)
                .add_extension(x509.ExtendedKeyUsage(
                    [x509.oid.ExtendedKeyUsageOID.CLIENT_AUTH]),
                    critical=False)
                .sign(self.ca_key, hashes.SHA256()))
        return cert.public_bytes(serialization.Encoding.PEM)


def approve_csr(client, name: str, message: str = "approved") -> dict:
    """kubectl certificate approve analog: append the Approved condition."""
    res = client.resource("certificatesigningrequests", None)
    csr = res.get(name)
    status = csr.setdefault("status", {})
    conds = status.setdefault("conditions", [])
    if not _is_approved(csr):
        conds.append({"type": "Approved", "status": "True",
                      "reason": "ManualApproval", "message": message,
                      "lastUpdateTime": rfc3339_now()})
    return res.update_status(csr)


def deny_csr(client, name: str, message: str = "denied") -> dict:
    res = client.resource("certificatesigningrequests", None)
    csr = res.get(name)
    status = csr.setdefault("status", {})
    if not _is_denied(csr):  # idempotent, like approve_csr
        status.setdefault("conditions", []).append(
            {"type": "Denied", "status": "True", "reason": "ManualDenial",
             "message": message, "lastUpdateTime": rfc3339_now()})
    return res.update_status(csr)
