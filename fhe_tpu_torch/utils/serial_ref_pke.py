"""Reader/writer for the REFERENCE's serialized PKE objects (cereal
portable-binary + JSON archives).

Port of fhe_tpu/utils/serial_ref_pke.py: host code on numpy alone, kept
as the port's own copy (the port imports nothing of fhe_tpu).

Covers the full object graph the reference serializes for CKKS
(ciphertext-ser.h / cryptocontext-ser.h / key/key-ser.h):

  Ciphertext<DCRTPoly>  = shared_ptr -> CiphertextImpl v1:
      CryptoObject v0 { cc: CryptoContext, kt: keyTag string }
      v:  vector<DCRTPoly>      sl/l/t/d: u32   s: f64
      si: NativeInteger         e: u32          m: metadata map
  CryptoContext         = shared_ptr -> CryptoContextImpl v1:
      cc: POLYMORPHIC CryptoParametersCKKSRNS (RNS <- RLWE <- Base
          { elp: ILDCRTParams, enp: EncodingParams } + numeric fields)
      kt: POLYMORPHIC SchemeCKKSRNS (FHE/schswitch null ptrs + enabled)
      si: u32 scheme id
  PrivateKey/PublicKey  = shared_ptr -> KeyImpl v1:
      CryptoObject v0 + sk: DCRTPoly | pk: vector<DCRTPoly>

Wire format facts (cereal 1.3 portable-binary, all little-endian;
verified field-by-field against reference-produced archives in
tests/vectors/pke_*.bin):

  * u8 endian flag (1) opens the archive;
  * shared_ptr: u32 id -- 0 = null, msb (0x80000000) set = first
    occurrence (object data follows inline), else a back-reference;
  * POLYMORPHIC shared_ptr additionally leads with u32 polymorphic_id:
    0 = nullptr, 0x40000000 = serialized as the declared type,
    msb set = new registered type (name string follows), else a
    back-reference into the name table;
  * unique_ptr: u32 polymorphic marker (0x40000000) + u8 valid flag;
  * class versions (u32) are written ONCE per type per archive, at the
    type's first occurrence;
  * std::string / std::vector: u64 count + payload;
  * NativeVector: u64 size + raw u64 data + modulus (NativeInteger);
  * BigIntegerFixedT: vector<u64> words (little-endian limbs) + u32 MSB.

The reader produces plain Python trees (dicts/lists/ints/floats/numpy)
that `dump_binary` serializes back BYTE-IDENTICALLY; `dcrt_to_arrays`
lifts a DCRTPoly's towers into host arrays, which the caller moves onto
its device, so reference-encrypted data decrypts through the port's own
ring arithmetic.

Reference: the reference's src/core/include/utils/serial.h:101-177,
cereal install tree (install/include/openfhe/cereal), field order from
the save() methods cited per node below.
"""

from __future__ import annotations

import struct

import numpy as np

MSB = 0x80000000
MSB2 = 0x40000000


# ---------------------------------------------------------------------------
# low-level stream
# ---------------------------------------------------------------------------

class Reader:
    def __init__(self, data: bytes):
        self.d = data
        self.o = 0
        self.seen_versions: set[str] = set()

    def u8(self):
        v = self.d[self.o]
        self.o += 1
        return v

    def u32(self):
        v = struct.unpack_from("<I", self.d, self.o)[0]
        self.o += 4
        return v

    def u64(self):
        v = struct.unpack_from("<Q", self.d, self.o)[0]
        self.o += 8
        return v

    def f64(self):
        v = struct.unpack_from("<d", self.d, self.o)[0]
        self.o += 8
        return v

    def f32(self):
        v = struct.unpack_from("<f", self.d, self.o)[0]
        self.o += 4
        return v

    def u64s(self, n):
        v = np.frombuffer(self.d, dtype="<u8", count=n, offset=self.o).copy()
        self.o += 8 * n
        return v

    def string(self):
        n = self.u64()
        s = self.d[self.o:self.o + n].decode()
        self.o += n
        return s

    def version(self, type_name: str):
        """Class version: u32, present only at the type's first use."""
        if type_name in self.seen_versions:
            return None
        self.seen_versions.add(type_name)
        return self.u32()


class Writer:
    def __init__(self):
        self.parts: list[bytes] = []
        self.seen_versions: set[str] = set()

    def u8(self, v):
        self.parts.append(bytes([v & 0xFF]))

    def u32(self, v):
        self.parts.append(struct.pack("<I", v))

    def u64(self, v):
        self.parts.append(struct.pack("<Q", int(v)))

    def f64(self, v):
        self.parts.append(struct.pack("<d", v))

    def f32(self, v):
        self.parts.append(struct.pack("<f", v))

    def u64s(self, arr):
        self.parts.append(np.asarray(arr, dtype="<u8").tobytes())

    def string(self, s: str):
        b = s.encode()
        self.u64(len(b))
        self.parts.append(b)

    def version(self, type_name: str, v):
        if type_name in self.seen_versions:
            return
        self.seen_versions.add(type_name)
        self.u32(0 if v is None else v)

    def bytes_(self):
        return b"".join(self.parts)


# ---------------------------------------------------------------------------
# node parsers (field order = the reference save() methods)
# ---------------------------------------------------------------------------

def _shared(r: Reader, inner, polymorphic=False):
    """cereal shared_ptr: [poly id (+name)] + ptr id (+ inline data)."""
    node = {}
    if polymorphic:
        pid = r.u32()
        node["poly_id"] = pid
        if pid == 0:
            return node                      # nullptr
        if pid & MSB:
            node["poly_name"] = r.string()
    ptr = r.u32()
    node["ptr_id"] = ptr
    if ptr & MSB:
        node["data"] = inner(r)
    return node


def _w_shared(w: Writer, node, inner, polymorphic=False):
    if polymorphic:
        pid = node["poly_id"]
        w.u32(pid)
        if pid == 0:
            return
        if pid & MSB:
            w.string(node["poly_name"])
    w.u32(node["ptr_id"])
    if node["ptr_id"] & MSB:
        inner(w, node["data"])


def _native_int(r: Reader):
    r.version("NativeInt")
    return r.u64()


def _w_native_int(w: Writer, v):
    w.version("NativeInt", 1)
    w.u64(v)


def _big_int(r: Reader):
    """BigIntegerFixedT: vector<u64> limb words + u32 MSB count."""
    r.version("BigInt")
    n = r.u64()
    words = r.u64s(n)
    msb = r.u32()
    return {"words": words, "msb": msb}


def _w_big_int(w: Writer, v):
    w.version("BigInt", 1)
    w.u64(len(v["words"]))
    w.u64s(v["words"])
    w.u32(v["msb"])


def _elem_params(r: Reader, big: bool):
    """ElemParams<IntType> (elemparams.h:228): co rd cm ru bm br."""
    r.version("ElemParams" + ("B" if big else "N"))
    intf = _big_int if big else _native_int
    return {"co": r.u32(), "rd": r.u32(), "cm": intf(r), "ru": intf(r),
            "bm": intf(r), "br": intf(r)}


def _w_elem_params(w: Writer, v, big: bool):
    w.version("ElemParams" + ("B" if big else "N"), 1)
    intf = _w_big_int if big else _w_native_int
    w.u32(v["co"])
    w.u32(v["rd"])
    intf(w, v["cm"])
    intf(w, v["ru"])
    intf(w, v["bm"])
    intf(w, v["br"])


def _il_native_params(r: Reader):
    r.version("ILNativeParams")
    return {"base": _elem_params(r, big=False)}


def _w_il_native_params(w: Writer, v):
    w.version("ILNativeParams", 1)
    _w_elem_params(w, v["base"], big=False)


def _il_dcrt_params(r: Reader):
    """ILDCRTParams (ildcrtparams.h:332): ElemParams<BigInteger> base +
    vector<shared_ptr<ILNativeParams>>."""
    r.version("ILDCRTParams")
    base = _elem_params(r, big=True)
    n = r.u64()
    towers = [_shared(r, _il_native_params, polymorphic=True)
              for _ in range(n)]
    return {"base": base, "towers": towers}


def _w_il_dcrt_params(w: Writer, v):
    w.version("ILDCRTParams", 1)
    _w_elem_params(w, v["base"], big=True)
    w.u64(len(v["towers"]))
    for t in v["towers"]:
        _w_shared(w, t, _w_il_native_params, polymorphic=True)


def _encoding_params(r: Reader):
    """EncodingParamsImpl (encodingparams.h): m ru bm bru g bs."""
    r.version("EncodingParams")
    return {"m": r.u64(), "ru": _native_int(r), "bm": _native_int(r),
            "bru": _native_int(r), "g": r.u32(), "bs": r.u32()}


def _w_encoding_params(w: Writer, v):
    w.version("EncodingParams", 1)
    w.u64(v["m"])
    _w_native_int(w, v["ru"])
    _w_native_int(w, v["bm"])
    _w_native_int(w, v["bru"])
    w.u32(v["g"])
    w.u32(v["bs"])


def _crypto_params_ckksrns(r: Reader):
    """CryptoParametersCKKSRNS <- RNS <- RLWE <- Base save chains
    (schemebase/base-cryptoparameters.h:168, cryptoparameters-rlwe,
    schemerns/rns-cryptoparameters.h, ckksrns-cryptoparameters.h)."""
    r.version("CPCKKSRNS")
    r.version("CPRNS")
    r.version("CPRLWE")
    r.version("CPBase")
    out = {}
    out["elp"] = _shared(r, _il_dcrt_params, polymorphic=True)
    out["enp"] = _shared(r, _encoding_params, polymorphic=True)
    # CryptoParametersRLWE: dp/am/nest are C++ `float` (f32); widths
    # verified against reference archives (dp at byte 418 of pke_cc.bin)
    out["dp"] = r.f32()
    out["am"] = r.f32()
    out["ns"] = r.u32()
    out["rw"] = r.u64()
    out["nest"] = r.f64()
    out["muld"] = r.u32()
    out["addc"] = r.u32()
    out["kswc"] = r.u32()
    out["phops"] = r.u32()
    # CryptoParametersRNS
    out["md"] = r.u32()
    out["mo"] = r.u32()
    out["pmo"] = r.u32()
    out["mmo"] = r.u32()
    out["exm"] = r.u32()
    out["dnm"] = r.u32()
    out["slv"] = r.u32()
    out["fdp"] = r.f64()
    out["ss"] = r.f64()
    out["aq"] = r.f64()
    out["tp"] = r.u32()
    # CryptoParametersCKKSRNS
    out["ks"] = r.u32()
    out["rs"] = r.u32()
    out["encs"] = r.u32()
    out["muls"] = r.u32()
    out["dnum"] = r.u32()
    out["ab"] = r.u32()
    out["eb"] = r.u32()
    out["ccl"] = r.u32()
    out["cd"] = r.u32()
    out["rws"] = r.u32()
    out["cdt"] = r.u32()
    return out


def _w_crypto_params_ckksrns(w: Writer, v):
    w.version("CPCKKSRNS", 0)
    w.version("CPRNS", 0)
    w.version("CPRLWE", 0)
    w.version("CPBase", 0)
    _w_shared(w, v["elp"], _w_il_dcrt_params, polymorphic=True)
    _w_shared(w, v["enp"], _w_encoding_params, polymorphic=True)
    w.f32(v["dp"])
    w.f32(v["am"])
    w.u32(v["ns"])
    w.u64(v["rw"])
    w.f64(v["nest"])
    for k in ("muld", "addc", "kswc", "phops", "md", "mo", "pmo", "mmo",
              "exm", "dnm", "slv"):
        w.u32(v[k])
    w.f64(v["fdp"])
    w.f64(v["ss"])
    w.f64(v["aq"])
    w.u32(v["tp"])
    for k in ("ks", "rs", "encs", "muls", "dnum", "ab", "eb", "ccl",
              "cd", "rws", "cdt"):
        w.u32(v[k])


def _scheme_ckksrns(r: Reader):
    """SchemeCKKSRNS <- SchemeRNS <- SchemeBase: two null polymorphic
    ptrs (m_FHE, m_SchemeSwitch) + enabled-features mask."""
    r.version("SchemeCKKSRNS")
    r.version("SchemeRNS")
    r.version("SchemeBase")
    fhe = r.u32()
    assert fhe == 0, f"non-null FHE capability ptr {fhe:#x} unsupported"
    sw = r.u32()
    assert sw == 0, f"non-null schswitch ptr {sw:#x} unsupported"
    return {"fhe": fhe, "schswitch": sw, "enabled": r.u32()}


def _w_scheme_ckksrns(w: Writer, v):
    w.version("SchemeCKKSRNS", 0)
    w.version("SchemeRNS", 0)
    w.version("SchemeBase", 0)
    w.u32(v["fhe"])
    w.u32(v["schswitch"])
    w.u32(v["enabled"])


def _crypto_context(r: Reader):
    """CryptoContextImpl (cryptocontext.h:4028): cc kt si."""
    r.version("CryptoContext")
    return {"cc": _shared(r, _crypto_params_ckksrns, polymorphic=True),
            "kt": _shared(r, _scheme_ckksrns, polymorphic=True),
            "si": r.u32()}


def _w_crypto_context(w: Writer, v):
    w.version("CryptoContext", 1)
    _w_shared(w, v["cc"], _w_crypto_params_ckksrns, polymorphic=True)
    _w_shared(w, v["kt"], _w_scheme_ckksrns, polymorphic=True)
    w.u32(v["si"])


def _native_vector(r: Reader):
    """NativeVector (mubintvecnat.h:656): size + raw u64 + modulus."""
    r.version("NativeVector")
    n = r.u64()
    vals = r.u64s(n) if n else np.zeros(0, np.uint64)
    return {"v": vals, "m": _native_int(r)}


def _w_native_vector(w: Writer, v):
    w.version("NativeVector", 1)
    w.u64(len(v["v"]))
    if len(v["v"]):
        w.u64s(v["v"])
    _w_native_int(w, v["m"])


def _native_poly(r: Reader):
    """PolyImpl (poly.h:335): v (unique_ptr<NativeVector>) f p."""
    r.version("NativePoly")
    pid = r.u32()
    assert pid == MSB2, f"poly marker {pid:#x}"
    valid = r.u8()
    vals = _native_vector(r) if valid else None
    fmt = r.u32()
    p = _shared(r, _il_native_params, polymorphic=True)
    return {"v": vals, "f": fmt, "p": p}


def _w_native_poly(w: Writer, v):
    w.version("NativePoly", 1)
    w.u32(MSB2)
    w.u8(1 if v["v"] is not None else 0)
    if v["v"] is not None:
        _w_native_vector(w, v["v"])
    w.u32(v["f"])
    _w_shared(w, v["p"], _w_il_native_params, polymorphic=True)


def _dcrt_poly(r: Reader):
    """DCRTPolyImpl (dcrtpoly.h:336): v (vector<NativePoly>) f p."""
    r.version("DCRTPoly")
    n = r.u64()
    towers = [_native_poly(r) for _ in range(n)]
    fmt = r.u32()
    p = _shared(r, _il_dcrt_params, polymorphic=True)
    return {"v": towers, "f": fmt, "p": p}


def _w_dcrt_poly(w: Writer, v):
    w.version("DCRTPoly", 1)
    w.u64(len(v["v"]))
    for t in v["v"]:
        _w_native_poly(w, t)
    w.u32(v["f"])
    _w_shared(w, v["p"], _w_il_dcrt_params, polymorphic=True)


def _crypto_object(r: Reader):
    """CryptoObject (cryptoobject.h:102): cc (context ptr) + keyTag."""
    r.version("CryptoObject")
    return {"cc": _shared(r, _crypto_context, polymorphic=True),
            "kt": r.string()}


def _w_crypto_object(w: Writer, v):
    w.version("CryptoObject", 0)
    _w_shared(w, v["cc"], _w_crypto_context, polymorphic=True)
    w.string(v["kt"])


def _metadata_map(r: Reader):
    """m_metadataMap: shared_ptr<map<string, shared_ptr<Metadata>>>."""
    ptr = r.u32()
    node = {"ptr_id": ptr}
    if ptr & MSB:
        n = r.u64()
        assert n == 0, "non-empty metadata maps unsupported"
        node["n"] = n
    return node


def _w_metadata_map(w: Writer, v):
    w.u32(v["ptr_id"])
    if v["ptr_id"] & MSB:
        w.u64(v["n"])


def _ciphertext_impl(r: Reader):
    """CiphertextImpl (ciphertext.h:464): base + v sl l t d s si e m."""
    r.version("Ciphertext")
    out = {"base": _crypto_object(r)}
    n = r.u64()
    out["v"] = [_dcrt_poly(r) for _ in range(n)]
    out["sl"] = r.u32()
    out["l"] = r.u32()
    out["t"] = r.u32()
    out["d"] = r.u32()
    out["s"] = r.f64()
    out["si"] = _native_int(r)
    out["e"] = r.u32()
    out["m"] = _metadata_map(r)
    return out


def _w_ciphertext_impl(w: Writer, v):
    w.version("Ciphertext", 1)
    _w_crypto_object(w, v["base"])
    w.u64(len(v["v"]))
    for p in v["v"]:
        _w_dcrt_poly(w, p)
    w.u32(v["sl"])
    w.u32(v["l"])
    w.u32(v["t"])
    w.u32(v["d"])
    w.f64(v["s"])
    _w_native_int(w, v["si"])
    w.u32(v["e"])
    _w_metadata_map(w, v["m"])


def _private_key_impl(r: Reader):
    """PrivateKeyImpl (key/privatekey.h:160): base_class<Key> (which is
    base_class<CryptoObject>, adding its own class version) + sk."""
    r.version("PrivateKey")
    r.version("Key")
    return {"base": _crypto_object(r), "s": _dcrt_poly(r)}


def _w_private_key_impl(w: Writer, v):
    w.version("PrivateKey", 0)
    w.version("Key", 0)
    _w_crypto_object(w, v["base"])
    _w_dcrt_poly(w, v["s"])


def _public_key_impl(r: Reader):
    """PublicKeyImpl (key/publickey.h:152): base_class<Key> + h."""
    r.version("PublicKey")
    r.version("Key")
    out = {"base": _crypto_object(r)}
    n = r.u64()
    out["h"] = [_dcrt_poly(r) for _ in range(n)]
    return out


def _w_public_key_impl(w: Writer, v):
    w.version("PublicKey", 0)
    w.version("Key", 0)
    _w_crypto_object(w, v["base"])
    w.u64(len(v["h"]))
    for p in v["h"]:
        _w_dcrt_poly(w, p)


# ---------------------------------------------------------------------------
# archive entry points
# ---------------------------------------------------------------------------

_TOP = {
    "ciphertext": (_ciphertext_impl, _w_ciphertext_impl, True),
    "private_key": (_private_key_impl, _w_private_key_impl, True),
    "public_key": (_public_key_impl, _w_public_key_impl, True),
    "context": (_crypto_context, _w_crypto_context, True),
}


def load_binary(path: str, kind: str):
    """Parse a reference SerType::BINARY archive into a Python tree."""
    rd, _, poly = _TOP[kind]
    with open(path, "rb") as f:
        r = Reader(f.read())
    if r.u8() != 1:
        raise ValueError("not a little-endian cereal portable-binary stream")
    tree = _shared(r, rd, polymorphic=poly)
    if r.o != len(r.d):
        raise ValueError(f"{len(r.d) - r.o} trailing bytes (parse drift)")
    return tree


def dump_binary(tree, kind: str) -> bytes:
    """Re-serialize a parsed tree; byte-identical to the source archive."""
    _, wr, poly = _TOP[kind]
    w = Writer()
    w.u8(1)
    _w_shared(w, tree, wr, polymorphic=poly)
    return w.bytes_()


# ---------------------------------------------------------------------------
# lifting into host arrays
# ---------------------------------------------------------------------------

def dcrt_to_arrays(poly: dict) -> tuple[np.ndarray, tuple, str]:
    """[L, N] uint64 residues + moduli + format ('COEFF'/'EVAL').

    The reference stores EVALUATION towers in its own bit-reversed-
    index NTT convention; COEFFICIENT-format data (f == 1) is
    convention-free and is what the KAT replay consumes."""
    towers = poly["v"]
    vals = np.stack([t["v"]["v"] for t in towers])
    mods = tuple(int(t["v"]["m"]) for t in towers)
    fmt = "EVAL" if poly["f"] == 0 else "COEFF"
    return vals, mods, fmt


def context_summary(tree: dict) -> dict:
    """Ring/chain/scale facts from a parsed context (or any object
    embedding one)."""
    cc = tree["data"]
    if "base" in cc:                       # ciphertext/key: context inside
        cc = cc["base"]["cc"]["data"]
    params = cc["cc"]["data"]
    elp = params["elp"]["data"]
    mods = tuple(int(t["data"]["base"]["cm"]) for t in elp["towers"])
    return {
        "ring_dim": elp["base"]["rd"],
        "moduli": mods,
        "scaling_mod_size": params["rws"],
        "ks_technique": params["ks"],
        "scheme_id": cc["si"],
    }


def build_ptr_table(tree) -> dict:
    """Map ptr_id (sans msb) -> data for every first-occurrence shared
    pointer in a parsed tree, so back-references resolve."""
    table: dict = {}

    def walk(node):
        if isinstance(node, dict):
            if "ptr_id" in node and (node["ptr_id"] & MSB) and \
                    "data" in node:
                table[node["ptr_id"] & ~MSB] = node["data"]
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(tree)
    return table


def deref(node: dict, table: dict):
    """Data of a shared-ptr node, following a back-reference if needed."""
    if "data" in node:
        return node["data"]
    return table[node["ptr_id"] & ~MSB]
