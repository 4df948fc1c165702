"""Port parity: the roofline (``src/repro_torch/launch/roofline.py``), the
dry-run validator and the op accounting's forward FLOPs, against the
reference's ``repro/launch/roofline.py``, ``validate_dryrun.py`` and
``hlo_analysis.analyze_hlo``.

* ``active_params`` (total and active) and ``model_flops_per_device``
  equal the reference's exactly: ten archs × the four ``SHAPES`` × meshes
  (1, 1), (4, 1), (16, 16) × gossip nodes 1 and 4;
* ``roofline_terms``, ``to_markdown`` and ``dryrun_markdown`` on hand-built
  records equal the reference's once its three v5e constants are replaced
  by the port's H100 ones (the port adds the wire's transport: a key of
  the terms and a line under each table);
* ``is_suspect`` gives the reference's verdict on a record of each kind;
* the op accounting's ``dot_flops`` of every ``-reduced`` forward (B 2,
  S 64) equals the reference's ``analyze_hlo`` of its jitted forward.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_NAMES  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.launch import validate_dryrun as jvalid  # noqa: E402
from repro.launch.hlo_analysis import analyze_hlo  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.common import abstract_params as jabstract  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs.base import SHAPES as TSHAPES  # noqa: E402
from repro_torch.launch import roofline as troof  # noqa: E402
from repro_torch.launch import validate_dryrun as tvalid  # noqa: E402
from repro_torch.launch.hlo_analysis import analyze_step  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.common import abstract_params as tabstract  # noqa: E402

MESHES = [{"data": 1, "model": 1}, {"data": 4, "model": 1}, {"data": 16, "model": 16}]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_active_params_and_model_flops_match_the_reference(arch):
    jcfg, tcfg = jget(arch), tget(arch)
    for total in (False, True):
        assert troof.active_params(tcfg, total=total) == jroof.active_params(jcfg, total=total)
    for name, jshape in JSHAPES.items():
        for mesh in MESHES:
            for g in (1, 4):
                assert troof.model_flops_per_device(tcfg, TSHAPES[name], mesh, g) == \
                    jroof.model_flops_per_device(jcfg, jshape, mesh, g), (name, mesh, g)


def _hand_records():
    """Records of each kind the tables read: loop-aware ``hlo`` (train,
    prefill, decode, with collectives), a legacy one with ``cost`` only, a
    tagged variant and a failed one."""
    hlo = lambda flops, traffic, wire, counts: {
        "dot_flops": flops, "traffic_bytes": traffic, "total_wire_bytes": wire,
        "coll_counts": counts}
    mem = lambda a, t: {"argument_bytes": a, "temp_bytes": t, "output_bytes": a,
                        "alias_bytes": a}
    return [
        {"arch": "granite-8b", "shape": "train_4k", "mesh": "single", "kind": "train",
         "mesh_shape": {"data": 16, "model": 1}, "gossip_nodes": 16,
         "graph": "one_peer_exp(n=16)", "compile_s": 0, "memory": mem(8.2e10, 1.4e11),
         "hlo": hlo(4.55e15, 1.7e13, 4.6e10, {"collective-permute": 24})},
        {"arch": "phi3.5-moe-42b-a6.6b", "shape": "prefill_32k", "mesh": "single",
         "kind": "prefill", "mesh_shape": {"data": 16, "model": 1},
         "memory": mem(7.8e10, 3.7e10), "hlo": hlo(2.14e15, 9.3e12, 0, {})},
        {"arch": "rwkv6-1.6b", "shape": "decode_32k", "mesh": "multi", "kind": "decode",
         "mesh_shape": {"pod": 2, "data": 16, "model": 1},
         "memory": mem(3.3e9, 2.1e6), "hlo": hlo(3.1e10, 4.2e9, 1.5e5, {"all-reduce": 2})},
        {"arch": "kimi-k2-1t-a32b", "shape": "long_500k", "mesh": "single", "kind": "decode",
         "mesh_shape": {"data": 1, "model": 1}, "memory": mem(2.1e12, 6.4e7),
         "cost": {"flops": 8.3e12, "bytes_accessed": 2.2e12},
         "collectives": {"total_wire_bytes": 0}},
        {"arch": "zamba2-7b", "shape": "train_4k", "mesh": "single", "kind": "train",
         "tag": "remat-off", "mesh_shape": {"data": 16, "model": 1},
         "memory": mem(9.0e10, 1.0e11), "hlo": hlo(5.0e15, 2.0e13, 5.0e10, {})},
        {"arch": "granite-8b", "shape": "decode_32k", "mesh": "single",
         "error": "RuntimeError: boom"},
    ]


@pytest.fixture
def reference_on_h100(monkeypatch):
    """The reference's roofline with the port's three constants."""
    monkeypatch.setattr(jroof, "PEAK_FLOPS", troof.PEAK_FLOPS)
    monkeypatch.setattr(jroof, "HBM_BW", troof.HBM_BW)
    monkeypatch.setattr(jroof, "ICI_BW", troof.NVLINK_BW)


def test_roofline_terms_match_the_reference(reference_on_h100):
    for rec in _hand_records():
        if "error" in rec:
            continue
        got = troof.roofline_terms(rec)
        assert got.pop("transport") == "nvlink"
        assert got == jroof.roofline_terms(rec), rec["arch"]


def test_markdown_tables_match_the_reference(reference_on_h100, tmp_path):
    import json

    path = tmp_path / "records.json"
    path.write_text(json.dumps(_hand_records()))
    rows_t, rows_j = troof.analyze(str(path)), jroof.analyze(str(path))
    note = "\n\ncollective term over nvlink at 450 GB/s a card, one way"
    assert troof.to_markdown(rows_t) == jroof.to_markdown(rows_j) + note
    for mesh in ("single", "multi"):
        assert troof.dryrun_markdown(rows_t, mesh) == jroof.dryrun_markdown(rows_j, mesh) + note


def test_is_suspect_agrees_with_the_reference():
    base = _hand_records()[0]
    model = jroof.model_flops_per_device(jget("granite-8b"), JSHAPES["train_4k"],
                                         base["mesh_shape"], 16)
    cases = {
        "error": {"arch": "granite-8b", "shape": "train_4k", "mesh": "single", "error": "x"},
        "no-hlo": {k: v for k, v in base.items() if k != "hlo"},
        "zero": {**base, "hlo": {**base["hlo"], "dot_flops": 0.0}},
        "low": {**base, "hlo": {**base["hlo"], "dot_flops": 0.1 * model}},
        "high": {**base, "hlo": {**base["hlo"], "dot_flops": 9.0 * model}},
        "ok": base,
    }
    verdicts = {name: tvalid.is_suspect(rec) for name, rec in cases.items()}
    assert verdicts == {name: jvalid.is_suspect(rec) for name, rec in cases.items()}
    assert verdicts["ok"] is None and all(v for k, v in verdicts.items() if k != "ok")


def test_roofline_cli_reads_a_record_file(tmp_path, capsys):
    import json

    path = tmp_path / "records.json"
    path.write_text(json.dumps(_hand_records()))
    troof.main(["--in", str(path), "--md"])
    out = capsys.readouterr().out
    assert "| granite-8b | train_4k | single |" in out and "over nvlink" in out
    troof.main(["--in", str(path)])
    assert "(nvlink)" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# The op accounting's forward FLOPs against the reference's HLO
# ---------------------------------------------------------------------------

B, S = 2, 64


def _reference_dot_flops(jcfg, fn) -> float:
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    batch = {"tokens": tok, "targets": tok}
    if jcfg.input_kind == "vlm":
        batch["patch_embeds"] = jax.ShapeDtypeStruct((B, jcfg.n_patches, jcfg.d_model),
                                                     jnp.float32)
    params = jabstract(jtfm.model_defs(jcfg, 1))
    return analyze_hlo(jax.jit(fn).lower(params, batch).compile().as_text())["dot_flops"]


def _meta_batch(tcfg) -> dict:
    batch = {k: torch.empty((B, S), dtype=torch.int32, device="meta")
             for k in ("tokens", "targets")}
    if tcfg.input_kind == "vlm":
        batch["patch_embeds"] = torch.empty((B, tcfg.n_patches, tcfg.d_model), device="meta")
    return batch


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_forward_dot_flops_equal_the_reference_hlo(arch):
    jcfg, tcfg = jget(arch + "-reduced"), tget(arch + "-reduced")
    ref = _reference_dot_flops(
        jcfg, lambda p, b: jtfm.forward(p, jcfg, b["tokens"],
                                        patch_embeds=b.get("patch_embeds"))[0])
    params, batch = tabstract(ttfm.model_defs(tcfg)), _meta_batch(tcfg)
    got = analyze_step(lambda: ttfm.forward(params, tcfg, batch["tokens"],
                                            patch_embeds=batch.get("patch_embeds")))
    assert got["dot_flops"] == ref
    assert got["traffic_bytes"] > 0 and got["total_wire_bytes"] == 0
