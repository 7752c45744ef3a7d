"""Declarative ASN.1-UPER schema combinators (engine for messages.py).

Values are plain Python: sequences are dicts, choices are ("name", value)
tuples, sequence-of are lists, enums are their string names, bit strings
are ints (with declared width), octet strings are bytes.
"""

from __future__ import annotations

from .per import BitReader, BitWriter, get_length_det, put_length_det, width


class Type:
    def pack(self, w: BitWriter, v):
        raise NotImplementedError

    def unpack(self, r: BitReader):
        raise NotImplementedError


class Null(Type):
    def pack(self, w, v):
        pass

    def unpack(self, r):
        return None


class Bool(Type):
    def pack(self, w, v):
        w.put(1 if v else 0, 1)

    def unpack(self, r):
        return bool(r.get(1))


class Int(Type):
    def __init__(self, lo: int, hi: int):
        self.lo, self.hi = lo, hi
        self.w = width(lo, hi)

    def pack(self, w, v):
        if not self.lo <= v <= self.hi:
            raise ValueError(f"int {v} out of [{self.lo},{self.hi}]")
        w.put(v - self.lo, self.w)

    def unpack(self, r):
        return self.lo + r.get(self.w)


class Enum(Type):
    """Enumerated; names may be a list of strings or an int count
    (then values are plain ints). ext=True adds the extension bit."""

    def __init__(self, names, ext: bool = False):
        self.names = names if isinstance(names, (list, tuple)) else None
        self.n = len(names) if self.names else names
        self.ext = ext
        self.w = width(0, self.n - 1)

    def pack(self, w, v):
        if self.ext:
            w.put(0, 1)
        idx = self.names.index(v) if self.names else int(v)
        w.put(idx, self.w)

    def unpack(self, r):
        if self.ext and r.get(1):
            raise ValueError("extended enum value")
        idx = r.get(self.w)
        if idx >= self.n:
            raise ValueError(f"enum index {idx} out of range")
        return self.names[idx] if self.names else idx


class BitString(Type):
    """Fixed-size bit string carried as an int (MSB first)."""

    def __init__(self, n: int):
        self.n = n

    def pack(self, w, v):
        w.put(int(v), self.n)

    def unpack(self, r):
        return r.get(self.n)


class OctetString(Type):
    """Fixed length (n) or variable (lo..hi, or unconstrained)."""

    def __init__(self, n: int | None = None, lo: int = 0,
                 hi: int | None = None):
        self.n, self.lo, self.hi = n, lo, hi

    def pack(self, w, v: bytes):
        if self.n is not None:
            assert len(v) == self.n
        elif self.hi is not None:
            w.put(len(v) - self.lo, width(self.lo, self.hi))
        else:
            put_length_det(w, len(v))
        w.put_bytes(v)

    def unpack(self, r):
        if self.n is not None:
            n = self.n
        elif self.hi is not None:
            n = self.lo + r.get(width(self.lo, self.hi))
        else:
            n = get_length_det(r)
        return r.get_bytes(n)


class Field:
    def __init__(self, name: str, typ: Type, optional: bool = False,
                 default=None):
        self.name, self.typ, self.optional = name, typ, optional
        self.default = default


def f(name, typ, optional=False, default=None):
    return Field(name, typ, optional, default)


class Seq(Type):
    """SEQUENCE with optional-presence bitmap (values are dicts; an
    optional field is absent when the key is missing or value is None).

    Extension additions (X.691 18.7-18.9) round-trip opaquely: decoded
    into "_ext" as a list of raw open-type byte strings (None for absent
    additions) and re-emitted verbatim on pack."""

    def __init__(self, *fields: Field, ext: bool = False):
        self.fields = fields
        self.ext = ext

    def pack(self, w, v: dict):
        exts = v.get("_ext") if isinstance(v, dict) else None
        if self.ext:
            w.put(1 if exts else 0, 1)
        for fl in self.fields:
            if fl.optional:
                w.put(0 if v.get(fl.name) is None else 1, 1)
        for fl in self.fields:
            if fl.optional:
                val = v.get(fl.name)
                if val is None:
                    continue       # absent (defaults never auto-encode)
            else:
                val = v.get(fl.name, fl.default)
                if val is None and not isinstance(fl.typ, Null):
                    raise ValueError(f"missing field {fl.name}")
            fl.typ.pack(w, val)
        if exts:
            # normally-small length (X.691 10.9.3.4) + presence bitmap +
            # open-type additions
            n = len(exts)
            assert n <= 64, "large extension counts unsupported"
            w.put(0, 1)
            w.put(n - 1, 6)
            for e in exts:
                w.put(0 if e is None else 1, 1)
            for e in exts:
                if e is not None:
                    put_length_det(w, len(e))
                    w.put_bytes(e)

    def unpack(self, r):
        ext_present = self.ext and r.get(1)
        present = {}
        for fl in self.fields:
            present[fl.name] = r.get(1) if fl.optional else 1
        out = {}
        for fl in self.fields:
            if present[fl.name]:
                out[fl.name] = fl.typ.unpack(r)
            else:
                out[fl.name] = None
        if ext_present:
            if r.get(1) == 0:
                n = r.get(6) + 1
            else:
                n = get_length_det(r)
            bitmap = [r.get(1) for _ in range(n)]
            exts = []
            for p in bitmap:
                if p:
                    ln = get_length_det(r)
                    exts.append(r.get_bytes(ln))
                else:
                    exts.append(None)
            out["_ext"] = exts
        return out


class RawTail(Type):
    """Opaque remainder of the PDU (late non-critical extensions we pass
    through verbatim): value is (n_bits, int)."""

    def pack(self, w, v):
        n, bits = v
        w.put(bits, n)

    def unpack(self, r):
        n = r.remaining
        return (n, r.get(n))


class Choice(Type):
    """Value is ("optionName", innerValue).

    ``ext_options`` are extension additions (X.691 23.5/23.8): selected by
    a normally-small index after the extension bit and wrapped as an open
    type (octet-aligned self-contained encoding with a length determinant).
    Unknown addition indices decode to ("_extN", raw_bytes) and re-encode
    verbatim."""

    def __init__(self, options: list[tuple[str, Type]], ext: bool = False,
                 ext_options: list[tuple[str, Type]] = ()):  # type: ignore
        self.options = options
        self.ext = ext or bool(ext_options)
        self.ext_options = list(ext_options)
        self.w = width(0, len(options) - 1)

    def pack(self, w, v):
        name, inner = v
        root = next((i for i, (n, _) in enumerate(self.options) if n == name),
                    None)
        if root is not None:
            if self.ext:
                w.put(0, 1)
            w.put(root, self.w)
            self.options[root][1].pack(w, inner)
            return
        w.put(1, 1)
        if name.startswith("_ext"):
            idx, data = int(name[4:]), inner
        else:
            idx = next(i for i, (n, _) in enumerate(self.ext_options)
                       if n == name)
            inner_w = BitWriter()
            self.ext_options[idx][1].pack(inner_w, inner)
            data = inner_w.to_bytes() or b"\x00"
        assert idx < 64, "large addition indices unsupported"
        w.put(idx, 7)  # normally-small: 0-bit + 6-bit value
        put_length_det(w, len(data))
        w.put_bytes(data)

    def unpack(self, r):
        if self.ext and r.get(1):
            if r.get(1):
                raise ValueError("large choice addition index")
            idx = r.get(6)
            ln = get_length_det(r)
            data = r.get_bytes(ln)
            if idx < len(self.ext_options):
                name, typ = self.ext_options[idx]
                return (name, typ.unpack(BitReader(data)))
            return (f"_ext{idx}", data)
        idx = r.get(self.w)
        if idx >= len(self.options):
            raise ValueError(f"choice index {idx} out of range")
        name, typ = self.options[idx]
        return (name, typ.unpack(r))


class SeqOf(Type):
    def __init__(self, typ: Type, lo: int, hi: int):
        self.typ, self.lo, self.hi = typ, lo, hi
        self.w = width(lo, hi)

    def pack(self, w, v: list):
        if not self.lo <= len(v) <= self.hi:
            raise ValueError(f"seq-of count {len(v)}")
        w.put(len(v) - self.lo, self.w)
        for item in v:
            self.typ.pack(w, item)

    def unpack(self, r):
        n = self.lo + r.get(self.w)
        return [self.typ.unpack(r) for _ in range(n)]
