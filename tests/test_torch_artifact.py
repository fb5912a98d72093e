"""Port parity of the artifact store (``repro_torch.artifact``): the
committed golden artifact loads and reproduces its golden outputs
exactly through the port's engine; the recomputed id matches; a flipped
byte is refused; and the same tables saved by the port and by the JAX
package get the same artifact id, packed and unpacked."""
import hashlib
import json
import pathlib
import shutil

import numpy as np
import pytest
import torch

from repro.artifact import load_artifact as jload
from repro.artifact import save_artifact as jsave
from repro.core import lut_synth as LS
from repro_torch.artifact import (ArtifactError, copy_artifact,
                                  find_artifacts, load_artifact,
                                  save_artifact, verify_artifact)
from repro_torch.core import lut_synth as TLS
from repro_torch.kernels.lut_gather import ops as tops

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"


def test_golden_loads_and_reproduces_outputs():
    io = np.load(GOLDEN / "golden_io.npz")
    codes = torch.from_numpy(io["inputs"])
    for unpack in (True, False):
        art = load_artifact(str(GOLDEN), unpack_int4=unpack, device="cpu")
        assert art.artifact_id == str(io["artifact_id"])
        assert any(t.sub_packed for t in art.tables) == (not unpack)
        assert all(t.conn.device.type == "cpu" for t in art.tables)
        for kw in (dict(), dict(pipeline=True), dict(fused=False)):
            fn = tops.make_network_fn(art, device="cpu", **kw)
            np.testing.assert_array_equal(fn(codes).numpy(),
                                          io["outputs"])
    m = verify_artifact(str(GOLDEN))
    recomputed = hashlib.sha256(json.dumps(
        {"layers": m["layers"], "slabs": m["slabs"]},
        sort_keys=True).encode()).hexdigest()
    assert recomputed == str(io["artifact_id"]) == m["artifact_id"]
    assert art.spec.widths == (16, 10, 5)


def test_corrupt_artifacts_are_refused(tmp_path):
    src = find_artifacts(str(GOLDEN))[0]
    bad = copy_artifact(src, str(tmp_path))
    slabs = pathlib.Path(bad) / "slabs.bin"
    data = bytearray(slabs.read_bytes())
    data[len(data) // 2] ^= 0x01
    slabs.write_bytes(bytes(data))
    with pytest.raises(ArtifactError, match="hash mismatch"):
        verify_artifact(bad)
    with pytest.raises(ArtifactError, match="hash mismatch"):
        load_artifact(bad, device="cpu")
    slabs.write_bytes(bytes(data[:100]))
    with pytest.raises(ArtifactError, match="truncated"):
        load_artifact(bad, device="cpu")
    with pytest.raises(ArtifactError):
        load_artifact(str(tmp_path / "missing"), device="cpu")


def test_port_save_matches_reference_artifact_id(tmp_path):
    """Same tables, same id — through ``tables_from_numpy`` from the JAX
    package's tables, saved with and without int4 packing, from packed
    and unpacked tables; the port's load of the JAX save round-trips."""
    jart = jload(str(GOLDEN))
    spec = jart.spec
    variants = {"unpacked": jart.tables,
                "packed": LS.pack_tables_int4(jart.tables)}
    ids = {}
    for vname, jt in variants.items():
        tt = TLS.tables_from_numpy(jt, "cpu")
        for int4 in (True, False):
            jp = jsave(str(tmp_path / f"j-{vname}-{int4}"), jt, spec=spec,
                       int4=int4)
            tp = save_artifact(str(tmp_path / f"t-{vname}-{int4}"), tt,
                               spec=spec, int4=int4)
            jid = json.loads((pathlib.Path(jp) / "manifest.json")
                             .read_text())["artifact_id"]
            tman = verify_artifact(tp)
            assert tman["artifact_id"] == jid, (vname, int4)
            assert (pathlib.Path(tp) / "slabs.bin").read_bytes() == \
                (pathlib.Path(jp) / "slabs.bin").read_bytes()
            assert tman["cost_model"] == json.loads(
                (pathlib.Path(jp) / "manifest.json").read_text()
            )["cost_model"]
            ids[(vname, int4)] = jid
            back = load_artifact(jp, device="cpu")
            for a, b in zip(back.tables, TLS.tables_from_numpy(
                    jart.tables, "cpu")):
                for f in ("conn", "sub_table", "add_table", "routing"):
                    assert torch.equal(getattr(a, f), getattr(b, f))
    # pack state never changes the id; int4 on/off is a different id
    assert ids[("unpacked", True)] == ids[("packed", True)] == \
        jart.artifact_id
    assert ids[("unpacked", False)] == ids[("packed", False)]
    assert ids[("unpacked", True)] != ids[("unpacked", False)]
    shutil.rmtree(tmp_path)
