"""PyTorch port: multi-rank batch fan-out (``parallel/mesh.py``), ADMMA's
data-parallel training, the LT fan-out and the CLIs' ``--mesh``, on the CPU
over gloo ranks (one process per rank, ``parallel.mesh.spawn``).

- exact replay, N = 2: the summed tallies of every leg (MSA and SPA on the
  BSC and biAWGN, the erasure SPA, ADMM with its 2000-bin histogram, LP,
  the rotating and the joint ensemble routes) equal the sum of
  single-process replays of each rank's stream at batch / 2, chunk for
  chunk, for as many chunks as the mesh run took; the ranks agree; no rank
  imports jax; only rank 0 writes, and its Saver file has the one-rank
  file's schema and rank 0's numbers;
- the tally summed through the main group at dispatch (the design of
  NCCL meshes, forced on a gloo mesh by setting ``Mesh.device_tally``)
  gives the sums of the host design (gloo's);
- the cap sweep on two ranks: its per-cap tallies equal the replays too;
- N = 1: a mesh of one rank gives exactly what no mesh gives (plain,
  rotating, joint, LT), and rank 0 of 1 draws the stream of a run without
  a mesh;
- divisibility: ``local_batch`` raises as the JAX one does, and so do the
  runners, the CLI and ``stream_batches`` on a batch that does not divide;
- mesh validation: ``batch_mesh`` / ``code_mesh`` raise when asked for
  more ranks than the world has (``test_code_mesh_validates_device_count``
  of the JAX tests); NCCL ranks need a card each;
- ADMMA: after data-parallel training the two ranks' MLPs are equal bit
  for bit and have moved; WER within 6 SE of one rank
  (``tests/test_harness.py::test_runner_admma_train_sharded_matches_single``);
- the JAX runner on a 2-device batch mesh and the port on 2 ranks, same
  ADMM configuration: WER within 6 SE;
- the LT CLI with ``--mesh 2``, fresh and resumed: ``arr`` equals the
  rank-ordered concatenation of single-process replays of each rank's
  stream;
- ``main --mesh 2 --device cpu`` writes one Saver file.

Each rank runs one thread; the ranks of a file's runs share one spawn
where they can (a spawn costs a few seconds here).
"""

import dataclasses
import json
import math
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402

from ldpc_decoders_tpu.harness import runner as jax_runner  # noqa: E402
from ldpc_decoders_tpu.parallel import mesh as jax_mesh  # noqa: E402
from ldpc_decoders_tpu_torch import campaign  # noqa: E402
from ldpc_decoders_tpu_torch import main as port_main  # noqa: E402
from ldpc_decoders_tpu_torch.codes import ensembles  # noqa: E402
from ldpc_decoders_tpu_torch.codes.code import save_parity_mtx  # noqa: E402
from ldpc_decoders_tpu_torch.decoders.admma import mlp_init  # noqa: E402
from ldpc_decoders_tpu_torch.fountain import lt  # noqa: E402
from ldpc_decoders_tpu_torch.harness import (  # noqa: E402
    CapSweepRunner,
    MonteCarloRunner,
    RunConfig,
    run_rotating_members,
)
from ldpc_decoders_tpu_torch.harness.ensemble_runner import (  # noqa: E402
    EnsembleMonteCarloRunner,
)
from ldpc_decoders_tpu_torch.harness.runner import point_generator  # noqa: E402
from ldpc_decoders_tpu_torch.parallel import mesh  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 2
FLAG = "1200_3_6_ldpc"
HMG = "7_4_hamming"
MEMBERS = ["mesh48_1", "mesh48_2", "mesh48_3"]
COMMON = dict(device="cpu", log_freq=1e9)

# name -> (kind, RunConfig): the legs of the fan-out run.
LEGS = {
    "msa_bsc": ("plain", RunConfig("bsc", FLAG, "MSA", [0.035, 0.03],
                                   codeword=1, min_wec=40, batch=128,
                                   **COMMON)),
    "msa_biawgn": ("plain", RunConfig("biawgn", FLAG, "MSA", [2.5],
                                      codeword=1, min_wec=20, batch=128,
                                      msg_dtype="bfloat16", **COMMON)),
    "spa_bsc": ("plain", RunConfig("bsc", FLAG, "SPA", [0.05], codeword=0,
                                   min_wec=20, batch=128, **COMMON)),
    "spa_biawgn": ("plain", RunConfig("biawgn", FLAG, "SPA", [2.0],
                                      codeword=0, min_wec=20, batch=128,
                                      inf_policy="saturate", **COMMON)),
    "bec": ("plain", RunConfig("bec", FLAG, "SPA", [0.37], codeword=0,
                               min_wec=20, batch=128, **COMMON)),
    "admm": ("plain", RunConfig("bsc", HMG, "ADMM", [0.04], codeword=1,
                                min_wec=20, batch=256, max_iter=50,
                                **COMMON)),
    "lp": ("plain", RunConfig("bsc", HMG, "LP", [0.06], codeword=1,
                              min_wec=10, batch=64, **COMMON)),
    "rotating": ("rotating", RunConfig("biawgn", "mesh48", "MSA", [1.5],
                                       codeword=1, min_wec=10, batch=64,
                                       **COMMON)),
    "joint": ("joint", RunConfig("bsc", "mesh48", "SPA", [0.06], codeword=0,
                                 min_wec=10, batch=64, **COMMON)),
}
CAPS = RunConfig("bsc", FLAG, "MSA", [0.04], codeword=1, min_wec=15,
                 batch=128, **COMMON)
CAP_LABELS = [10, 0, 2]
ADMMA = RunConfig("bsc", HMG, "ADMMA", [0.02], codeword=1, min_wec=3,
                  batch=128, max_iter=30, train=True, layers=[16], **COMMON)


def _se(a, b):
    return math.sqrt(a["wer"] / a["tot"] + b["wer"] / b["tot"]) + 1e-12


@pytest.fixture(scope="module")
def codes_dir(tmp_path_factory):
    """Three (48,3,6) members in a code directory of their own, beside a
    copy of the flagship's file, named in the environment the spawned ranks
    inherit."""
    codes = tmp_path_factory.mktemp("codes")
    shutil.copy(os.path.join(ROOT, "data", "codes", FLAG + ".txt"), codes)
    rng = np.random.default_rng(11)
    for name in MEMBERS:
        save_parity_mtx(ensembles.rand_reg_ldpc(48, 3, 6, rng), name,
                        str(codes))
    old = os.environ.get("FILE_CODES_DIR")
    os.environ["FILE_CODES_DIR"] = str(codes)
    yield codes
    if old is None:
        del os.environ["FILE_CODES_DIR"]
    else:
        os.environ["FILE_CODES_DIR"] = old


@pytest.fixture(scope="module")
def fanout(codes_dir, tmp_path_factory):
    """Every leg and the ADMMA training, in one spawn of two ranks; the
    plain legs write Saver files. Returns ({leg: cfg}, [rank outputs])."""
    out_dir = tmp_path_factory.mktemp("fanout")
    cfgs = {}
    tasks = []
    for name, (kind, cfg) in LEGS.items():
        if kind == "plain":
            cfg = dataclasses.replace(cfg, data_dir=str(out_dir / name))
        cfgs[name] = cfg
        tasks.append(("harness", dict(cfg=cfg, kind=kind,
                                      members=MEMBERS if kind != "plain"
                                      else None)))
    admma = dataclasses.replace(ADMMA, cache_dir=str(out_dir / "cache"))
    cfgs["admma"] = admma
    tasks.append(("harness", dict(cfg=admma)))
    for leg in ("msa_bsc", "joint"):
        kind, cfgs[f"device_tally_{leg}"] = LEGS[leg]
        tasks.append(("torch_mesh_ranks:harness_summed_at_dispatch",
                      dict(cfg=LEGS[leg][1], kind=kind, members=MEMBERS)))
    cfgs["caps"] = dataclasses.replace(CAPS, data_dir=str(out_dir / "caps"))
    tasks.append(("harness", dict(cfg=cfgs["caps"], kind="caps",
                                  caps=CAP_LABELS)))
    outs = mesh.spawn("ldpc_decoders_tpu_torch.parallel.jobs:sequence", N,
                      args=(tasks,), device="cpu", num_threads=1)
    return cfgs, {name: [outs[r][i] for r in range(N)]
                  for i, name in enumerate(cfgs)}


def _strip(res):
    """{param: stats} without the rank's own clock."""
    return {p: {k: v for k, v in st.items() if k != "words_per_sec"}
            for p, st in res.items()}


def _strip_all(kind, res):
    return (_strip(res) if kind == "plain"
            else {m: _strip(r) for m, r in res.items()})


def _replay(cfg, seed, idx, param, chunks):
    """Sum over ranks r of ``chunks`` chunks of rank r's stream, decoded
    in one process at batch / N: the packed tally, as int64."""
    runner = MonteCarloRunner(dataclasses.replace(
        cfg, batch=cfg.batch // N, seed=seed, data_dir=None))
    acc = 0
    for r in range(N):
        gen = point_generator(runner.device, seed, idx, r, N)
        for _ in range(chunks):
            acc = acc + runner._dispatch(param, gen)[0].numpy().astype(
                np.int64)
    return acc


def _check_point(res, want):
    assert (res["wec"], res["bec"]) == (int(want[0]), int(want[1]))
    if want.size > 2:
        assert res["dec"]["iter"] == want[2:].tolist()
        assert sum(res["dec"]["iter"]) == res["tot"]


@pytest.mark.parametrize("leg", list(LEGS))
def test_fanout_equals_rank_replays(fanout, leg):
    cfgs, outs = fanout
    kind, _ = LEGS[leg]
    cfg = cfgs[leg]
    res = outs[leg][0]["results"]
    assert _strip_all(kind, outs[leg][1]["results"]) == \
        _strip_all(kind, res)                        # the ranks agree
    assert not any(o["jax"] for o in outs[leg])
    assert [o["coordinator"] for o in outs[leg]] == [True, False]
    if kind == "plain":
        for idx, p in enumerate(cfg.params):
            assert res[p]["tot"] % cfg.batch == 0 and res[p]["wec"] >= \
                cfg.min_wec
            _check_point(res[p], _replay(cfg, cfg.seed, idx, p,
                                         res[p]["tot"] // cfg.batch))
        return
    # Ensemble routes: member m draws from the generator a run seeded
    # seed + m uses (the joint route decodes a member only while it runs,
    # so its generator advances by its own chunks, tot / batch).
    for m, name in enumerate(MEMBERS):
        for idx, p in enumerate(cfg.params):
            st = res[name][p]
            assert st["wec"] >= cfg.min_wec
            member = dataclasses.replace(cfg, code=name)
            _check_point(st, _replay(member, cfg.seed + m, idx, p,
                                     st["tot"] // cfg.batch))


@pytest.mark.parametrize("leg", ["msa_bsc", "admm"])
def test_one_writer_with_the_one_rank_schema(fanout, tmp_path, leg):
    cfgs, outs = fanout
    cfg = cfgs[leg]
    files = os.listdir(cfg.data_dir)
    assert len(files) == 1
    with open(os.path.join(cfg.data_dir, files[0])) as fp:
        saved = json.load(fp)
    one = dataclasses.replace(cfg, data_dir=str(tmp_path), max_words=cfg.batch)
    MonteCarloRunner(one).run()
    assert os.listdir(tmp_path) == files
    with open(tmp_path / files[0]) as fp:
        ref = json.load(fp)
    assert list(saved) == list(ref)
    res = outs[leg][0]["results"]
    for p in cfg.params:
        assert saved["wec"][str(p)] == res[p]["wec"]
        assert saved["tot"][str(p)] == res[p]["tot"]
    assert [o["saver"] for o in outs[leg]] == [True, False]


@pytest.mark.parametrize("leg", ["msa_bsc", "joint"])
def test_tally_summed_at_dispatch_equals_summed_at_consume(fanout, leg):
    """A mesh with ``device_tally`` set sums each chunk's tally through the
    main group when it is dispatched: the same streams give the same
    sums."""
    _, outs = fanout
    kind = LEGS[leg][0]
    dev = outs[f"device_tally_{leg}"][0]
    assert _strip_all(kind, dev["results"]) == \
        _strip_all(kind, outs[leg][0]["results"])
    # Over gloo the default sums on the host (a card's collective blocks).
    assert dev["device_tally"] and not outs[leg][0]["device_tally"]


def test_cap_sweep_fanout_equals_rank_replays(fanout):
    """The cap sweep on two ranks: every label's tally equals the sum of
    single-process replays of each rank's stream; only rank 0 writes, one
    file per label."""
    cfgs, outs = fanout
    cfg = cfgs["caps"]
    a, b = outs["caps"]
    assert _strip_all("rotating", a["results"]) == \
        _strip_all("rotating", b["results"])
    assert not a["jax"] and not b["jax"] and a["launches"] == b["launches"]
    assert len(os.listdir(cfg.data_dir)) == len(CAP_LABELS)
    p = cfg.params[0]
    tot = a["results"][CAP_LABELS[0]][p]["tot"]
    runner = CapSweepRunner(dataclasses.replace(
        cfg, batch=cfg.batch // N, data_dir=None), CAP_LABELS)
    acc = 0
    for r in range(N):
        gen = point_generator(runner.device, cfg.seed, 0, r, N)
        for _ in range(tot // cfg.batch):
            acc = acc + runner._dispatch(p, gen)[0].numpy().astype(np.int64)
    for k, lbl in enumerate(runner.order):
        st = a["results"][CAP_LABELS[lbl]][p]
        assert (st["tot"], st["wec"], st["bec"]) == (tot, acc[0][k],
                                                     acc[1][k])
        assert st["wec"] >= cfg.min_wec


def test_admma_data_parallel_training(fanout):
    cfgs, outs = fanout
    cfg = cfgs["admma"]
    a, b = outs["admma"]
    assert a["mlp"].keys() == b["mlp"].keys()
    for k in a["mlp"]:
        np.testing.assert_array_equal(a["mlp"][k], b["mlp"][k])
    start = mlp_init(4, cfg.layers, 0).state_dict()
    assert not np.allclose(a["mlp"]["w0"], start["w0"].numpy())
    res_m = a["results"][0.02]
    assert res_m["wec"] >= 3 and res_m["dec"]["average"] > 0
    res_s = MonteCarloRunner(cfg).run()[0.02]
    assert abs(res_m["wer"] - res_s["wer"]) < 6 * _se(res_m, res_s)


def test_fanout_against_the_jax_sharded_runner(fanout):
    """The JAX runner on a 2-device batch mesh (its own streams) and the
    port on two ranks: the same ADMM leg, WER within 6 SE and mean
    iterations within 25%."""
    cfgs, outs = fanout
    cfg = cfgs["admm"]
    port = outs["admm"][0]["results"][0.04]
    jcfg = jax_runner.RunConfig(
        **{k: getattr(cfg, k) for k in ("channel", "code", "decoder",
                                        "params", "codeword", "min_wec",
                                        "batch", "max_iter", "log_freq")})
    jm = JaxMesh(np.array(jax.devices()[:N]), ("batch",))
    theirs = jax_runner.MonteCarloRunner(jcfg, mesh=jm).run()[0.04]
    assert abs(port["wer"] - theirs["wer"]) < 6 * _se(port, theirs)
    a, b = port["dec"]["average"], theirs["dec"]["average"]
    assert abs(a - b) <= 0.25 * max(a, b)


# -- one rank ------------------------------------------------------------

@pytest.mark.parametrize("leg", ["msa_bsc", "admm", "rotating", "joint"])
def test_one_rank_mesh_is_no_mesh(codes_dir, leg):
    kind, cfg = LEGS[leg]
    one = mesh.batch_mesh(1)
    assert (one.size, one.width("batch"), one.index("batch")) == (1, 1, 0)
    if kind == "plain":
        cfg = dataclasses.replace(cfg, params=cfg.params[:1])
        a = MonteCarloRunner(cfg, mesh=one).run()
        b = MonteCarloRunner(cfg).run()
    elif kind == "rotating":
        a = run_rotating_members(cfg, MEMBERS, mesh=one)
        b = run_rotating_members(cfg, MEMBERS)
    else:
        a = EnsembleMonteCarloRunner(cfg, MEMBERS, mesh=one).run()
        b = EnsembleMonteCarloRunner(cfg, MEMBERS).run()
    assert _strip_all(kind, a) == _strip_all(kind, b)


def test_rank_zero_of_one_keeps_the_stream():
    a = point_generator("cpu", 5, 3)
    b = point_generator("cpu", 5, 3, 0, 1)
    c = point_generator("cpu", 5, 3, 0, 2)
    x, y, z = (torch.rand(8, generator=g) for g in (a, b, c))
    assert torch.equal(x, y) and not torch.equal(x, z)
    sim = lt.LTSimulator(40, 90, 0.1, 0.5, device="cpu")
    one = [r.tolist() for r in lt.stream_batches(
        sim, np.random.default_rng(1), 12, 8, mesh.batch_mesh(1))]
    ref = [r.tolist() for r in lt.stream_batches(
        sim, np.random.default_rng(1), 12, 8)]
    assert one == ref and [len(r) for r in one] == [8, 4]


# -- validation ------------------------------------------------------------

def test_local_batch_divisibility_as_jax():
    one = mesh.batch_mesh(1)
    jm = JaxMesh(np.array(jax.devices()[:1]), ("batch",))
    assert mesh.local_batch(96, one) == jax_mesh.local_batch(96, jm) == 96
    assert mesh.local_batch(96, 4) == 24
    for n in (5, 7):
        jm = JaxMesh(np.array(jax.devices()[:n]), ("batch",))
        with pytest.raises(ValueError, match="does not divide"):
            jax_mesh.local_batch(96, jm)
        with pytest.raises(ValueError, match="does not divide"):
            mesh.local_batch(96, n)
    with pytest.raises(ValueError, match="does not divide"):
        lt.batch_sizes(20, 8, 3)
    assert lt.batch_sizes(20, 8, 2) == [8, 8, 4]
    with pytest.raises(ValueError, match="does not divide"):
        list(lt.stream_batches(lt.LTSimulator(40, 90, 0.1, 0.5, device="cpu"),
                               np.random.default_rng(0), 9, 8, 2))


def test_mesh_validates_world_size():
    """Without a process group the world is one rank (the JAX test's 64
    devices on an 8-device host): asking for more raises."""
    with pytest.raises(ValueError, match="need"):
        mesh.batch_mesh(2)
    with pytest.raises(ValueError, match="need"):
        mesh.code_mesh(64)
    with pytest.raises(ValueError, match="need"):
        mesh.code_mesh(2, 4)
    m = mesh.code_mesh(1)
    assert m.shape == {"code": 1} and m.axis_names == ("code",)
    m = mesh.code_mesh(1, 1)
    assert m.shape == {"code": 1}
    with pytest.raises(ValueError, match="need"):
        MonteCarloRunner(LEGS["msa_bsc"][1], mesh=mesh.Mesh({"batch": 3}))
    with pytest.raises(ValueError, match="mesh axes"):
        mesh.Mesh({"chips": 1})


def test_backend_and_card_rules():
    assert mesh.resolve_backend("cpu") == "gloo"
    with pytest.raises(ValueError, match="NCCL"):
        mesh.resolve_backend("cpu", "nccl")
    with pytest.raises(ValueError, match="unknown backend"):
        mesh.resolve_backend("cpu", "mpi")
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match="need"):
        mesh._check_cards("nccl", have + 1)
    mesh._check_cards("gloo", have + 4)          # ranks may share cards
    # One rank and no launcher's world: the CLI runs in this process.
    assert "WORLD_SIZE" not in os.environ
    assert mesh.run_ranks("ldpc_decoders_tpu_torch.main:main", [], 1,
                          device="cpu") == (False, None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.spawn("ldpc_decoders_tpu_torch.parallel.jobs:kernel_launches",
                       2, device="cuda", backend="gloo")


@pytest.mark.parametrize("cli", ["main", "campaign", "luby"])
def test_cli_in_a_launcher_world_needs_its_mesh(monkeypatch, tmp_path, cli):
    """Under a launcher's world of two ranks (``WORLD_SIZE=2``), a CLI
    whose mesh flags ask for another number of ranks raises before it
    joins the world: without a mesh each rank would repeat the run."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    run = {"main": lambda a: port_main.main(
               ["bsc", HMG, "MSA", "--device", "cpu", "--console"] + a),
           "campaign": lambda a: campaign.main(
               ["HMG", "--device", "cpu", "--data_dir", str(tmp_path)] + a),
           "luby": lambda a: lt.main(
               ["40", "90", "0.1", "0.5", "8", "--device", "cpu",
                "--data_dir", str(tmp_path)] + a)}[cli]
    for extra in ([], ["--mesh", "4"]):
        with pytest.raises(ValueError, match="the world has 2 ranks"):
            run(extra)
    assert not torch.distributed.is_initialized()
    assert os.listdir(tmp_path) == []


def test_cli_mesh_argument_checks(capsys):
    for argv in (["--mesh", "3"], ["--mesh", "-1"],
                 ["--dist-backend", "nccl", "--device", "cpu"]):
        with pytest.raises(SystemExit):
            port_main.parse_args(["bsc", FLAG, "MSA"] + argv)
    err = capsys.readouterr().err
    assert "does not divide" in err and "count ranks" in err
    args = port_main.parse_args(["bsc", FLAG, "MSA", "--mesh", "2",
                                 "--mesh-code", "2", "--dist-backend", "gloo"])
    assert port_main.mesh_ranks(args) == 4 and args.dist_backend == "gloo"


# -- CLIs ----------------------------------------------------------------

def test_main_cli_mesh_writes_one_file(tmp_path):
    argv = ["bsc", HMG, "MSA", "--params", "0.05", "--codeword", "1",
            "--min-wec", "20", "--batch", "256", "--mesh", "2", "--device",
            "cpu", "--console", "--data_dir", str(tmp_path)]
    res = port_main.main(argv)
    assert os.listdir(tmp_path) == ["bsc-7_4_hamming-MSA-1-20-10.json"]
    with open(tmp_path / "bsc-7_4_hamming-MSA-1-20-10.json") as fp:
        saved = json.load(fp)
    assert saved["wec"]["0.05"] == res[0.05]["wec"] >= 20
    assert saved["tot"]["0.05"] % 256 == 0
    cfg = RunConfig("bsc", HMG, "MSA", [0.05], codeword=1, min_wec=20,
                    batch=256, **COMMON)
    _check_point(res[0.05], _replay(cfg, 0, 0, 0.05,
                                    res[0.05]["tot"] // 256))


def _lt_replay(argv_count, done, batch, seed=0):
    """The rank-ordered concatenation of each rank's single-process
    stream: batch j holds rank 0's share of it, then rank 1's."""
    sim = lt.LTSimulator(40, 90, 0.1, 0.5, device="cpu")
    per_rank = [list(lt.stream_batches(
        sim, lt.rank_rng(seed, done, r, N), (argv_count - done) // N,
        batch // N)) for r in range(N)]
    return [int(v) for j in range(len(per_rank[0]))
            for r in range(N) for v in per_rank[r][j]]


def test_lt_cli_mesh_equals_rank_replays_fresh_and_resumed(tmp_path):
    base = ["40", "90", "0.1", "0.5"]
    opts = ["--batch", "8", "--mesh", "2", "--device", "cpu", "--data_dir",
            str(tmp_path)]
    lt.main(base + ["16"] + opts)
    path = tmp_path / "luby-40-90-0.1-0.5.json"
    with open(path) as fp:
        fresh = json.load(fp)
    assert list(fresh) == ["type", "k", "n", "c", "delta", "arr"]
    assert fresh["arr"] == _lt_replay(16, 0, 8)
    lt.main(base + ["24"] + opts)
    with open(path) as fp:
        resumed = json.load(fp)["arr"]
    assert resumed[:16] == fresh["arr"]
    assert resumed[16:] == _lt_replay(24, 16, 8)
    assert os.listdir(tmp_path) == ["luby-40-90-0.1-0.5.json"]
