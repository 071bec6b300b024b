"""The port's wire-schema lint (``poseidon_tpu_torch/analysis/protocol.py``).

The port's clients and the JAX package's servers (and the reverse) speak
to each other, so the port's protocol schema must equal the JAX package's
``evidence/protocol_schema.json`` kind for kind, field for field and
reply key for reply key; only the file paths of dispatchers and senders
differ. Every PROTO rule fires on a fixture and stays quiet on its
well-formed twin. Tolerances: exact (sets of names, rule IDs).
"""

import json
import os
import textwrap

from poseidon_tpu_torch.analysis import filter_new, load_baseline
from poseidon_tpu_torch.analysis import protocol as P
from poseidon_tpu_torch.analysis.__main__ import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DISPATCHER_OK = '''
def recv_frame(conn): ...
def send_frame(conn, obj): ...
def server_handshake(conn, token): ...

class Service:
    def _serve(self, conn):
        if not server_handshake(conn, self.token):
            return
        while True:
            msg = recv_frame(conn)
            kind = msg["kind"]
            if kind == "ping":
                send_frame(conn, {"ok": True})
            elif kind == "put":
                w = msg["worker"]
                seq = msg.get("seq", msg["clock"])
                self.table[w] += msg["delta"]
                send_frame(conn, {"ok": True, "applied": seq})
            elif kind == "get":
                send_frame(conn, {"ok": True, "value": self.table})
'''

CLIENT_OK = '''
def send_frame(sock, obj): ...
def recv_frame(sock): ...

class Client:
    def _rpc(self, msg):
        send_frame(self._sock, msg)
        return recv_frame(self._sock)

    def ping(self):
        return self._rpc({"kind": "ping"})

    def put(self, delta):
        self._rpc({"kind": "put", "worker": self.w, "clock": self.c,
                   "seq": self.c, "delta": delta})

    def get(self):
        reply = self._rpc({"kind": "get"})
        return reply["value"]
'''

# the serving shape of the port: a dispatcher returns a handler's reply,
# the handler hands msg on to a shared submit path (two hops), and the
# client reads the reply through a helper it passes the rpc's result to
DISPATCHER_DELEGATING = '''
def recv_frame(conn): ...
def send_frame(conn, obj): ...
def server_handshake(conn, token): ...

class Server:
    def _serve_conn(self, conn):
        if not server_handshake(conn, self.token):
            return
        msg = recv_frame(conn)
        send_frame(conn, self._dispatch(msg))

    def _dispatch(self, msg):
        kind = msg["kind"]
        if kind == "infer":
            return self._handle_infer(msg)

    def _handle_infer(self, msg):
        return self._submit(msg["inputs"], msg)

    def _submit(self, inputs, msg):
        deadline = msg.get("deadline_ms")
        try:
            return {"ok": True, "outputs": inputs}
        except ValueError as e:
            return {"ok": False, "shed": True, "error": str(e)}
'''

CLIENT_DELEGATING = '''
def send_frame(sock, obj): ...
def recv_frame(sock): ...

class Client:
    def _rpc(self, msg):
        send_frame(self._sock, msg)
        return recv_frame(self._sock)

    @staticmethod
    def _outputs(reply):
        if not reply.get("ok"):
            raise ValueError(reply.get("error"), reply.get("shed"))
        return reply["outputs"]

    def infer(self, inputs, deadline_ms=None):
        msg = {"kind": "infer", "inputs": inputs}
        if deadline_ms is not None:
            msg["deadline_ms"] = deadline_ms
        return self._outputs(self._rpc(msg))
'''


def _spec(tmp_path, dispatcher_src, client_src, cls="Service",
          method="_serve", recv="_serve"):
    d = tmp_path / "svc.py"
    c = tmp_path / "cli.py"
    d.write_text(textwrap.dedent(dispatcher_src))
    c.write_text(textwrap.dedent(client_src))
    return P.ServiceSpec(name="fixture", dispatcher=(str(d), cls, method),
                         recv_method=recv, sender_files=(str(c),))


def _rules(findings):
    return sorted({f.rule for f in findings})


def _without_paths(schema):
    """The schema with every file path dropped (dispatchers, senders)."""
    out = json.loads(json.dumps(schema))
    for svc in out["services"].values():
        svc.pop("dispatcher", None)
        for kind in svc["kinds"].values():
            kind.pop("senders", None)
    return out


def test_port_schema_equals_the_jax_packages_paths_aside():
    schema, _ = P.extract_schema()
    with open(os.path.join(REPO, "evidence", "protocol_schema.json")) as f:
        jax_schema = json.load(f)
    assert _without_paths(schema)["services"] == \
        _without_paths(jax_schema)["services"]
    # and the senders are the same functions, in the port's files
    for name, svc in schema["services"].items():
        for kind, k in svc["kinds"].items():
            theirs = jax_schema["services"][name]["kinds"][kind]["senders"]
            assert [s.replace("poseidon_tpu_torch/", "poseidon_tpu/")
                    for s in k["senders"]] == theirs, (name, kind)


def test_shipped_schema_is_the_checked_in_golden():
    schema, _ = P.extract_schema()
    assert P.diff_schema(P.load_schema(), schema) == []
    assert P.SCHEMA_PATH.startswith(os.path.join(REPO,
                                                 "poseidon_tpu_torch"))


def test_the_services_and_framing_target_the_port():
    for spec in P.SERVICES:
        assert spec.dispatcher[0].startswith("poseidon_tpu_torch/")
        assert os.path.exists(os.path.join(REPO, spec.dispatcher[0]))
        for f in spec.sender_files:
            assert os.path.exists(os.path.join(REPO, f))
    assert P.FRAMING_TARGETS == ("poseidon_tpu_torch/proto/wire.py",)


def test_shipped_tree_has_no_unbaselined_proto_findings():
    assert filter_new(P.run_protocol_lint(), load_baseline()) == []


def test_well_formed_pair_is_quiet(tmp_path):
    _, fs = P.extract_service(_spec(tmp_path, DISPATCHER_OK, CLIENT_OK))
    assert fs == []


def test_delegation_is_followed_through_two_hops_and_a_read_helper(
        tmp_path):
    schema, fs = P.extract_service(_spec(
        tmp_path, DISPATCHER_DELEGATING, CLIENT_DELEGATING, cls="Server",
        method="_dispatch", recv="_serve_conn"))
    assert fs == []
    infer = schema["kinds"]["infer"]
    assert infer["required_fields"] == ["inputs"]
    assert infer["optional_fields"] == ["deadline_ms"]
    assert infer["reply_keys"] == ["error", "ok", "outputs", "shed"]
    assert infer["client_reads"] == ["error", "ok", "outputs", "shed"]


def test_proto201_202_203_204_fire(tmp_path):
    sent_unhandled = CLIENT_OK + '''
    def stats(self):
        return self._rpc({"kind": "stats"})
'''
    _, fs = P.extract_service(_spec(tmp_path, DISPATCHER_OK,
                                    sent_unhandled))
    assert _rules(fs) == ["PROTO201"]
    handled_unsent = DISPATCHER_OK + '''\
            elif kind == "flush":
                send_frame(conn, {"ok": True})
'''
    _, fs = P.extract_service(_spec(tmp_path, handled_unsent, CLIENT_OK))
    assert _rules(fs) == ["PROTO202"]
    field_missing = DISPATCHER_OK.replace(
        'self.table[w] += msg["delta"]',
        'self.table[w] += msg["delta"] * msg["scale"]')
    _, fs = P.extract_service(_spec(tmp_path, field_missing, CLIENT_OK))
    assert "PROTO203" in _rules(fs)
    reply_missing = CLIENT_OK.replace('return reply["value"]',
                                      'return reply["valeu"]')
    _, fs = P.extract_service(_spec(tmp_path, DISPATCHER_OK, reply_missing))
    assert _rules(fs) == ["PROTO204"]


def test_proto205_and_206_fire(tmp_path):
    no_auth = DISPATCHER_OK.replace(
        "        if not server_handshake(conn, self.token):\n"
        "            return\n", "")
    _, fs = P.extract_service(_spec(tmp_path, no_auth, CLIENT_OK))
    assert _rules(fs) == ["PROTO205"]
    no_seq = CLIENT_OK.replace('"clock": self.c,\n                   '
                               '"seq": self.c, ', '')
    _, fs = P.extract_service(_spec(tmp_path, DISPATCHER_OK, no_seq))
    assert "PROTO206" in _rules(fs)


FRAMING_OK = '''
import struct

def recv_exact(sock, n): ...
def max_frame(): ...

def recv(sock):
    (n,) = struct.unpack("!Q", recv_exact(sock, 8))
    cap = max_frame()
    if n > cap:
        raise ValueError(n)
    return recv_exact(sock, n)
'''


def test_proto207_framing(tmp_path):
    f = tmp_path / "framing.py"
    f.write_text(textwrap.dedent(FRAMING_OK.replace(
        "    cap = max_frame()\n    if n > cap:\n        raise ValueError(n)\n",
        "")))
    assert [x.key for x in P.lint_framing(str(f))] == ["unchecked-length"]
    f.write_text(textwrap.dedent(FRAMING_OK.replace(
        "cap = max_frame()", "cap = 1 << 32")))
    assert [x.key for x in P.lint_framing(str(f))] == ["absurd-cap"]
    f.write_text(textwrap.dedent(FRAMING_OK))
    assert P.lint_framing(str(f)) == []
    assert P.lint_framing(os.path.join(REPO, P.FRAMING_TARGETS[0])) == []


def test_cli_protocols_clean_and_schema_drift_exits_2(tmp_path, capsys):
    # an explicit path lints only it; --protocols still runs the
    # protocol lint and the schema gate over the port
    clean = tmp_path / "clean.py"
    clean.write_text("X = 1\n")
    assert main(["--protocols", str(clean)]) == 0
    golden = P.load_schema()
    golden["services"]["inference"]["kinds"].pop("stats")
    drifted = tmp_path / "schema.json"
    drifted.write_text(json.dumps(golden))
    assert main(["--protocols", "--schema", str(drifted), str(clean)]) == 2
    assert "schema drift" in capsys.readouterr().out
