"""The port's dry-runs beside the reference's, each in a subprocess (the
port starts a fake process group of 512 ranks, the reference needs 512
placeholder host devices before jax starts), all four at once:

* ``repro_torch.launch.dryrun --arch xlstm_125m --shape long_500k
  --multi-pod --device cpu`` against ``repro.launch.dryrun`` on the same
  cell: 512 chips, the reference's keys, ``param_count`` and
  ``model_flops`` equal, per-chip temp bytes under 16 GB and
  ``flops_per_chip`` within 0.5x-2x of the reference's;
* recurrentgemma-2b x long_500k on both meshes, port and reference: at
  batch 1 the products split over the data axes, FLOPs per chip and the
  useful fraction within 0.5x-2x of the reference's;
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
  model's FLOPs per chip (it did 7x, the CE's logits unsharded);
* xlstm cut in depth at 64 tokens, prefill and train, with its sLSTM's
  time loop run step by step and as one step charged for all: the same
  FLOPs, wire bytes and collectives, HBM bytes equal (prefill) or within
  1% (train).
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
RG_CELL = ["--arch", "recurrentgemma_2b", "--shape", "long_500k", "--both-meshes"]
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
        "port_rg": ["repro_torch.launch.dryrun", *RG_CELL, "--device", "cpu", "--out", str(tmp / "port")],
        "ref_rg": ["repro.launch.dryrun", *RG_CELL, "--out", str(tmp / "ref")],
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
    for k in ("port", "ref", "port_ring", "ref_ring", "port_rg", "ref_rg"):
        assert out[k][0] == 0, f"{k}: {out[k][1][-3000:]}"
    name = "xlstm_125m__long_500k__pod2.json"
    rg = {mesh: f"recurrentgemma_2b__long_500k__{mesh}.json" for mesh in ("pod1", "pod2")}
    return {
        "port": json.loads((tmp / "port" / name).read_text()),
        "ref": json.loads((tmp / "ref" / name).read_text()),
        "port_rg": {m: json.loads((tmp / "port" / n).read_text()) for m, n in rg.items()},
        "ref_rg": {m: json.loads((tmp / "ref" / n).read_text()) for m, n in rg.items()},
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


@pytest.mark.parametrize("mesh", ["pod1", "pod2"])
def test_dryrun_batch1_uses_data_axes(runs, mesh):
    # batch 1 leaves the data axes idle; the products split over them as
    # GSPMD splits them, so the port's FLOPs per chip come within 0.5-2x of
    # the reference's (2.5x when each product was split over "model" only)
    d, ref = runs["port_rg"][mesh], runs["ref_rg"][mesh]
    assert d["model_flops"] == ref["model_flops"]
    assert 0.5 <= d["flops_per_chip"] / ref["flops_per_chip"] <= 2.0
    assert 0.5 <= d["useful_flops_fraction"] / ref["useful_flops_fraction"] <= 2.0


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


# xlstm cut in depth, its sLSTM's time loop run step by step and as one step
# charged for all (``recurrent._FakeSteps``, ``opcount.repeated``)
STEPS_WORKER = textwrap.dedent(
    """
    import json, sys
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import recurrent as R

    torch.set_num_threads(1)
    dryrun.fake_world(256)
    cfg = dryrun.cut_depth(get_config("xlstm_125m"))
    fake = R.is_fake
    res = {}
    for shape in ("prefill_32k", "train_4k"):
        for way in ("loop", "once"):
            R.is_fake = (lambda t: False) if way == "loop" else fake
            _, costs = dryrun.lower_cell("xlstm_125m", shape, False, device="cpu", cfg=cfg, seq=64)
            res[shape + "/" + way] = costs.as_dict()
    with open(sys.argv[1], "w") as f:
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
    procs["steps"] = subprocess.Popen([sys.executable, "-c", STEPS_WORKER, str(tmp / "steps.json")],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
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
    return {a: json.loads((tmp / f"{a}.json").read_text()) for a in CUT_ARCHS + ["steps"]}


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


@pytest.mark.parametrize("shape", ["prefill_32k", "train_4k"])
def test_fake_steps_count_as_the_loop(cut_runs, shape):
    loop, once = cut_runs["steps"][shape + "/loop"], cut_runs["steps"][shape + "/once"]
    for key in ("dot_flops", "dot_flops_fp32", "collective_wire_bytes", "collective_count"):
        assert once[key] == loop[key], key
    # the train step's backward adds the one step's h gradients where the loop slices them
    assert abs(once["hbm_bytes"] / loop["hbm_bytes"] - 1) <= (0 if shape == "prefill_32k" else 0.01)
    assert loop["num_while_loops"] == 0 and once["num_while_loops"] == (1 if shape == "prefill_32k" else 3)
