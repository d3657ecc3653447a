"""The port's dry-runs beside the reference's, each in a subprocess (the
port starts a fake process group of 512 ranks, the reference needs 512
placeholder host devices before jax starts), all four at once:

* ``repro_torch.launch.dryrun --arch xlstm_125m --shape long_500k
  --multi-pod --device cpu`` against ``repro.launch.dryrun`` on the same
  cell: 512 chips, the reference's keys, ``param_count`` and
  ``model_flops`` equal, per-chip temp bytes under 16 GB and
  ``flops_per_chip`` within 0.5x-2x of the reference's;
* ``repro_torch.launch.selfjoin_dryrun --points 1048576 --device cpu``
  against ``repro.launch.selfjoin_dryrun``: the reference's
  ``model_flops`` in all six cells and a nonzero collective-permute;
* the report CLI on the port's JSON, and the dry-run's default device
  (``cuda``) refused without a card;
* on the 256-rank production mesh (a fake group, one subprocess per arch),
  one arch of each fault class that the port's DTensor seams had (strided
  head shards on both sides: phi3; a KV head count the model axis does not
  divide and the vocab-sharded CE: qwen3; MLA and FSDP experts:
  deepseek-v2; the experts: arctic; the recurrent projections:
  recurrentgemma) at full width, cut to one repeat of each layer group
  (``dryrun.cut_depth``),
  runs its train, prefill and decode cells with the sequence cut to two
  key chunks.  qwen3's train cell does no more than twice its share of the
  model's FLOPs per chip (it did 7x, the CE's logits unsharded).
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
DEADLINE_S = 600
CELL = ["--arch", "xlstm_125m", "--shape", "long_500k", "--multi-pod"]
TAGS = [f"{mesh}__{variant}" for mesh in ("pod1", "pod2") for variant in ("base", "overlap", "bf16")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=SRC, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    cmds = {
        "port": ["repro_torch.launch.dryrun", *CELL, "--device", "cpu", "--out", str(tmp / "port")],
        "ref": ["repro.launch.dryrun", *CELL, "--out", str(tmp / "ref")],
        "port_ring": ["repro_torch.launch.selfjoin_dryrun", "--points", "1048576", "--device", "cpu",
                      "--out", str(tmp / "port_ring.json")],
        "ref_ring": ["repro.launch.selfjoin_dryrun", "--points", "1048576",
                     "--out", str(tmp / "ref_ring.json")],
        "no_card": ["repro_torch.launch.dryrun", *CELL, "--out", str(tmp / "no_card")],
    }
    procs = {k: subprocess.Popen([sys.executable, "-m", *c], stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, env=env, cwd=str(tmp))
             for k, c in cmds.items()}
    out = {}
    try:
        for k, p in procs.items():
            out[k] = (p.wait(timeout=DEADLINE_S), p.stdout.read().decode())
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()
    for k in ("port", "ref", "port_ring", "ref_ring"):
        assert out[k][0] == 0, f"{k}: {out[k][1][-3000:]}"
    name = "xlstm_125m__long_500k__pod2.json"
    return {
        "port": json.loads((tmp / "port" / name).read_text()),
        "ref": json.loads((tmp / "ref" / name).read_text()),
        "port_ring": json.loads((tmp / "port_ring.json").read_text()),
        "ref_ring": json.loads((tmp / "ref_ring.json").read_text()),
        "no_card": out["no_card"],
        "dir": tmp / "port",
    }


def test_dryrun_cell_keys_and_mesh(runs):
    d, ref = runs["port"], runs["ref"]
    assert d["chips"] == 512 and d["mesh"] == ref["mesh"] == "pod=2xdata=16xmodel=16"
    assert set(ref) <= set(d)
    assert d["compute_s"] >= 0 and d["memory_s"] > 0
    assert d["dominant"] in ("compute", "memory", "collective")
    assert d["compile_s"] == 0.0 and d["lower_s"] > 0


def test_dryrun_counts_equal_reference(runs):
    d, ref = runs["port"], runs["ref"]
    for key in ("param_count", "active_param_count", "model_flops", "seq", "global_batch", "kind"):
        assert d[key] == ref[key], key


def test_dryrun_per_chip_costs(runs):
    d, ref = runs["port"], runs["ref"]
    # 512k-context decode state must be tiny (recurrent arch)
    assert 0 < d["temp_bytes_per_chip"] < 16e9
    assert 0.5 <= d["flops_per_chip"] / ref["flops_per_chip"] <= 2.0


@pytest.mark.parametrize("tag", TAGS)
def test_selfjoin_dryrun_cell(runs, tag):
    d, ref = runs["port_ring"][tag], runs["ref_ring"][tag]
    assert set(ref) <= set(d)
    assert d["model_flops"] == ref["model_flops"]
    assert d["chips"] == ref["chips"] and d["mesh"] == ref["mesh"]
    assert d["collective_by_type"]["collective-permute"] > 0
    assert d["flops_per_chip"] > 0


def test_report_renders_port_json(runs):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-m", "repro_torch.roofline.report", str(runs["dir"])],
                         capture_output=True, text=True, timeout=120, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "| xlstm_125m | long_500k | pod2 |" in res.stdout


@pytest.mark.skipif(torch.cuda.is_available(), reason="the default device is present")
def test_dryrun_default_device_needs_a_card(runs):
    code, text = runs["no_card"]
    assert code != 0 and "no CUDA device is available" in text


# -- every fault class's cells on the production mesh, cut in depth --------

CUT_ARCHS = ["phi3_mini_3p8b", "qwen3_32b", "deepseek_v2_236b", "arctic_480b", "recurrentgemma_2b"]
CUT_SHAPES = ["train_4k", "prefill_32k", "decode_32k"]
CUT_WORKER = textwrap.dedent(
    """
    import json, sys
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    arch, out = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    dryrun.fake_world(256)
    cfg = dryrun.cut_depth(get_config(arch))
    res = {}
    for shape in sys.argv[3:]:
        d, _ = dryrun.lower_cell(arch, shape, False, device="cpu", cfg=cfg, seq=2 * cfg.k_chunk)
        res[shape] = d
    with open(out, "w") as f:
        json.dump(res, f)
    """
)


@pytest.fixture(scope="module")
def cut_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_cut")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = {a: subprocess.Popen([sys.executable, "-c", CUT_WORKER, a, str(tmp / f"{a}.json"), *CUT_SHAPES],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
             for a in CUT_ARCHS}
    out = {}
    try:
        for a, p in procs.items():
            out[a] = (p.wait(timeout=DEADLINE_S), p.stdout.read().decode())
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()
    for a, (code, text) in out.items():
        assert code == 0, f"{a}: {text[-3000:]}"
    return {a: json.loads((tmp / f"{a}.json").read_text()) for a in CUT_ARCHS}


@pytest.mark.parametrize("shape", CUT_SHAPES)
@pytest.mark.parametrize("arch", CUT_ARCHS)
def test_cut_cell_runs_on_production_mesh(cut_runs, arch, shape):
    d = cut_runs[arch][shape]
    assert d["chips"] == 256 and d["mesh"] == "data=16xmodel=16"
    assert d["kind"] == shape.split("_")[0]
    assert d["flops_per_chip"] > 0 and d["model_flops"] > 0
    assert d["dominant"] in ("compute", "memory", "collective")
    assert d["temp_bytes_per_chip"] > 0


def test_qwen3_train_ce_sharded(cut_runs):
    d = cut_runs["qwen3_32b"]["train_4k"]
    assert d["useful_flops_fraction"] >= 0.5, d["useful_flops_fraction"]
