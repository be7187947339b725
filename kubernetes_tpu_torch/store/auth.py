"""Authentication, RBAC authorization, impersonation, audit.

Reference: the apiserver handler chain
(``staging/src/k8s.io/apiserver/pkg/server/config.go`` —
``DefaultBuildHandlerChain``: WithAuthentication -> WithAudit ->
WithImpersonation -> WithPriorityAndFairness -> WithAuthorization) and the
RBAC authorizer (``plugin/pkg/auth/authorizer/rbac/rbac.go``).

Shape here:

  Authenticator   bearer tokens -> UserInfo (token-auth-file analog; client
                  certs are a TLS concern — this server speaks plain HTTP, so
                  tokens are the only credential transport, as with upstream's
                  ServiceAccount tokens)
  RBACAuthorizer  Role/ClusterRole rules + (Cluster)RoleBindings, read live
                  from the object store so identities are managed through the
                  API like any other object; ``system:masters`` bypasses, as
                  upstream hardcodes in authorizer union
  AuditLog        JSON-lines ResponseComplete events (audit policy =
                  everything at Metadata level)
  Impersonation   Impersonate-User/-Group honored iff the real user may
                  ``impersonate`` users/groups

The chain order matches upstream: authenticate (401) before shaping (429)
before authorize (403) — an unauthenticated request must never consume an
APF seat, and authorization decisions are made with the impersonated user.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Optional


ANONYMOUS = "system:anonymous"
UNAUTHENTICATED = "system:unauthenticated"
AUTHENTICATED = "system:authenticated"
MASTERS = "system:masters"


@dataclass(frozen=True)
class UserInfo:
    name: str
    groups: tuple = ()

    def all_groups(self) -> set:
        g = set(self.groups)
        g.add(UNAUTHENTICATED if self.name == ANONYMOUS else AUTHENTICATED)
        return g


class AuthError(Exception):
    """401 — no or invalid credentials."""


class ForbiddenError(Exception):
    """403 — authenticated but not permitted."""


SA_TOKEN_TYPE = "kubernetes.io/service-account-token"
SA_NAME_ANNOTATION = "kubernetes.io/service-account.name"


class TokenAuthenticator:
    """Static bearer-token table (token-auth-file analog) plus dynamic
    resolution of ServiceAccount tokens minted by the token controller:
    Secrets of type ``kubernetes.io/service-account-token`` authenticate as
    ``system:serviceaccount:<ns>:<name>`` with the serviceaccounts groups
    (legacy SA token semantics — serviceaccount/tokens_controller.go)."""

    def __init__(self, tokens: Optional[dict] = None,
                 allow_anonymous: bool = True, secret_source=None):
        # token -> UserInfo | (name, groups)
        self._tokens: dict[str, UserInfo] = {}
        self.allow_anonymous = allow_anonymous
        self._secret_source = secret_source  # ObjectStore | None
        # token -> UserInfo index over SA-token secrets, keyed by the store's
        # resourceVersion: requests between writes hit the map in O(1); a
        # write (to anything) invalidates and the next SA-token request
        # rebuilds. Keeps the plaintext scan off the per-request hot path.
        self._sa_cache: tuple[int, dict] = (-1, {})
        for tok, who in (tokens or {}).items():
            self.add(tok, who)

    def _sa_lookup(self, token: str) -> Optional[UserInfo]:
        if self._secret_source is None:
            return None
        try:
            rv = self._secret_source.resource_version
            if rv != self._sa_cache[0]:
                secrets, list_rv = self._secret_source.list("Secret")
                index = {}
                for s in secrets:
                    if s.get("type") != SA_TOKEN_TYPE:
                        continue
                    tok = (s.get("data") or {}).get("token")
                    md = s.get("metadata") or {}
                    ns = md.get("namespace", "default")
                    sa = (md.get("annotations") or {}).get(SA_NAME_ANNOTATION, "")
                    if not tok or not sa:
                        continue
                    index[tok] = UserInfo(
                        name=f"system:serviceaccount:{ns}:{sa}",
                        groups=("system:serviceaccounts",
                                f"system:serviceaccounts:{ns}"))
                self._sa_cache = (list_rv, index)
        except Exception:  # ktpu-lint: disable=KTL002 -- fail closed: an unreadable SA token index authenticates nobody this request
            return None
        return self._sa_cache[1].get(token)

    def add(self, token: str, who) -> "TokenAuthenticator":
        if not isinstance(who, UserInfo):
            name, groups = who if isinstance(who, tuple) else (who, ())
            who = UserInfo(name=name, groups=tuple(groups))
        self._tokens[token] = who
        return self

    def authenticate(self, authorization_header: str) -> UserInfo:
        """-> UserInfo; raises AuthError on bad/missing credentials."""
        h = authorization_header or ""
        if h.lower().startswith("bearer "):
            token = h[7:].strip()
            user = self._tokens.get(token)
            if user is None:
                user = self._sa_lookup(token)
            if user is None:
                raise AuthError("invalid bearer token")
            return user
        if h:
            raise AuthError(f"unsupported authorization scheme")
        if self.allow_anonymous:
            return UserInfo(ANONYMOUS, (UNAUTHENTICATED,))
        raise AuthError("credentials required")


# --------------------------------------------------------------------- RBAC

def _rule_matches(rule: dict, verb: str, resource: str, name: str) -> bool:
    def has(key, x):
        vals = rule.get(key) or []
        return "*" in vals or x in vals
    if not has("verbs", verb):
        return False
    # subresource access must be granted explicitly ("pods/binding"), as
    # upstream RBAC requires; "*" covers everything
    if not has("resources", resource):
        return False
    names = rule.get("resourceNames") or []
    return not names or name in names


class RBACAuthorizer:
    """Roles/bindings read live from the store on every decision (the store
    list is an in-memory dict scan; upstream caches informers for the same
    effect). Kinds: Role/RoleBinding (namespaced), ClusterRole/
    ClusterRoleBinding (cluster-scoped)."""

    def __init__(self, store):
        self.store = store

    # -- helpers -----------------------------------------------------------

    def _subject_matches(self, subj: dict, user: UserInfo) -> bool:
        kind, name = subj.get("kind"), subj.get("name")
        if kind == "User":
            return name == user.name
        if kind == "Group":
            return name in user.all_groups()
        if kind == "ServiceAccount":
            ns = subj.get("namespace", "")
            return user.name == f"system:serviceaccount:{ns}:{name}"
        return False

    def _role_rules(self, ref: dict, binding_ns: str) -> list:
        kind = ref.get("kind")
        name = ref.get("name", "")
        try:
            if kind == "ClusterRole":
                role = self.store.get("ClusterRole", "", name)
            else:
                role = self.store.get("Role", binding_ns, name)
        except Exception:  # ktpu-lint: disable=KTL002 -- fail closed: an unresolvable role grants no rules
            return []
        return (role.get("rules") or [])

    # -- decision ----------------------------------------------------------

    def authorize(self, user: UserInfo, verb: str, resource: str,
                  namespace: str, name: str) -> bool:
        if MASTERS in user.all_groups():
            return True
        # cluster bindings grant everywhere
        cbs, _ = self.store.list("ClusterRoleBinding", namespace=None)
        for b in cbs:
            if not any(self._subject_matches(s, user)
                       for s in b.get("subjects") or []):
                continue
            for rule in self._role_rules(b.get("roleRef") or {}, ""):
                if _rule_matches(rule, verb, resource, name):
                    return True
        # namespaced bindings grant within their namespace only
        if namespace:
            rbs, _ = self.store.list("RoleBinding", namespace=namespace)
            for b in rbs:
                if not any(self._subject_matches(s, user)
                           for s in b.get("subjects") or []):
                    continue
                bns = (b.get("metadata") or {}).get("namespace", namespace)
                for rule in self._role_rules(b.get("roleRef") or {}, bns):
                    if _rule_matches(rule, verb, resource, name):
                        return True
        return False

    def can_impersonate(self, user: UserInfo,
                        groups: tuple = ()) -> bool:
        """User impersonation needs ``impersonate users``; requesting groups
        additionally needs ``impersonate groups`` for each requested group —
        otherwise any user-impersonation grant could self-attach
        system:masters and bypass authorization entirely."""
        if MASTERS in user.all_groups():
            return True
        if not self.authorize(user, "impersonate", "users", "", ""):
            return False
        return all(self.authorize(user, "impersonate", "groups", "", g)
                   for g in groups)


# -------------------------------------------------------------------- audit

class AuditLog:
    """JSON-lines audit sink (Metadata-level policy for every request —
    apiserver/pkg/audit). In-memory ring + optional file."""

    def __init__(self, path: Optional[str] = None, keep: int = 4096):
        self.path = path
        self.keep = keep
        self.events: list[dict] = []
        self._lock = threading.Lock()
        self._fh = open(path, "a", buffering=1) if path else None

    def log(self, *, user: UserInfo, verb: str, path: str, code: int,
            impersonated: Optional[str] = None):
        ev = {"stage": "ResponseComplete", "ts": time.time(),
              "user": user.name, "groups": sorted(user.all_groups()),
              "verb": verb, "requestURI": path, "code": code}
        if impersonated:
            ev["impersonatedUser"] = impersonated
        with self._lock:
            self.events.append(ev)
            if len(self.events) > self.keep:
                del self.events[: len(self.events) - self.keep]
            if self._fh:
                self._fh.write(json.dumps(ev) + "\n")

    def close(self):
        if self._fh:
            self._fh.close()


# --------------------------------------------------------- request -> verb

def request_verb(method: str, name: Optional[str], sub: Optional[str],
                 query: str) -> str:
    """HTTP -> RBAC verb (apiserver/pkg/endpoints/request/requestinfo.go)."""
    if method == "GET":
        if "watch=true" in (query or ""):
            return "watch"
        return "get" if name else "list"
    return {"POST": "create", "PUT": "update", "PATCH": "patch",
            "DELETE": "delete"}.get(method, method.lower())


def resource_for(plural: str, sub: Optional[str]) -> str:
    return f"{plural}/{sub}" if sub else plural


# ------------------------------------------------------------ default roles

def bootstrap_policy() -> list[dict]:
    """Default roles/bindings (bootstrappolicy/policy.go): the scheduler and
    controller-manager service identities get exactly the access their loops
    need; system:masters bypasses authorization entirely (superuser path)."""
    return [
        {"apiVersion": "rbac/v1", "kind": "ClusterRole",
         "metadata": {"name": "system:kube-scheduler"},
         "rules": [
             {"verbs": ["get", "list", "watch"],
              "resources": ["pods", "nodes", "persistentvolumes",
                            "persistentvolumeclaims", "storageclasses",
                            "namespaces", "poddisruptionbudgets"]},
             {"verbs": ["create", "get", "update", "patch"],
              "resources": ["events"]},
             {"verbs": ["create"], "resources": ["pods/binding"]},
             {"verbs": ["update", "patch"], "resources": ["pods/status"]},
             # preemption DELETEs victims directly (schedule_one.go), so the
             # scheduler holds delete on pods as upstream bootstrap policy does
             {"verbs": ["delete"], "resources": ["pods"]},
             {"verbs": ["create", "delete"], "resources": ["pods/eviction"]},
             {"verbs": ["get", "create", "update"], "resources": ["leases"]},
         ]},
        {"apiVersion": "rbac/v1", "kind": "ClusterRole",
         "metadata": {"name": "system:kube-controller-manager"},
         "rules": [{"verbs": ["*"], "resources": ["*"]}]},
        {"apiVersion": "rbac/v1", "kind": "ClusterRoleBinding",
         "metadata": {"name": "system:kube-scheduler"},
         "subjects": [{"kind": "User", "name": "system:kube-scheduler"}],
         "roleRef": {"kind": "ClusterRole", "name": "system:kube-scheduler"}},
        {"apiVersion": "rbac/v1", "kind": "ClusterRoleBinding",
         "metadata": {"name": "system:kube-controller-manager"},
         "subjects": [{"kind": "User",
                       "name": "system:kube-controller-manager"}],
         "roleRef": {"kind": "ClusterRole",
                     "name": "system:kube-controller-manager"}},
    ]
