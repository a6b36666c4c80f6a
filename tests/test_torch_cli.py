"""Port parity for the command-line tools: every subcommand but ``run``
through ``thunder_tpu.cli.main(["--cpu", ...])`` and
``thunder_tpu_torch.cli.main(["--cpu", ...])`` on the same input files
(n = 24), each into its own directory, the outputs read back and held
together, and the printed lines equal unless a number is a float sum:

- element-wise tools (mask, average, minus), the masks of ``genmask``,
  ``view``'s slices, ``select``'s gallery and kept table and the STAR
  converters byte for byte / exactly;
- FFT tools (project, reconstruct, lowpass, bfactor, resize, alignz,
  genmask_shell) within 1e-5 relative (``reconstruct``'s C-balance map
  within 1e-4);
- ``postprocess``, given the JAX package's phase fields, within 1e-4.

``run`` itself (tests/test_torch_dataset_run.py) is also started here as
two ranks of ``python -m thunder_tpu_torch.cli --cpu run`` under the JAX
package's launch variables and under torchrun's.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thunder_tpu.cli.main import main as jcli
from thunder_tpu.io import read_mrc, read_thu, write_mrc
from thunder_tpu.io.thu import make_table, write_thu
from thunder_tpu_torch.cli.main import main as tcli
from thunder_tpu_torch.core import postprocess as tpost

from test_torch_support import rank_env, rel_err, run_ranks_on_a_port, tt

torch.set_num_threads(1)

N = 24
B = 20


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """phantom.mrc, half maps, a noisy stack, poses.thu (with classes)
    and a class-average stack, written once."""
    d = tmp_path_factory.mktemp("cli_in")
    rng = np.random.default_rng(0)
    g = np.mgrid[:N, :N, :N].astype(np.float32) - N // 2
    vol = np.zeros((N, N, N), np.float32)
    for _ in range(5):
        c = rng.uniform(-N / 5, N / 5, 3)
        s = rng.uniform(N / 16, N / 9)
        vol += np.exp(-((g - c[:, None, None, None]) ** 2).sum(0)
                      / (2 * s * s)).astype(np.float32)
    write_mrc(str(d / "phantom.mrc"), vol, voxel_size=1.32)
    for h in "ab":
        write_mrc(str(d / f"half_{h}.mrc"), vol + rng.normal(
            0, 0.03, vol.shape).astype(np.float32), voxel_size=1.32)
    q = rng.normal(size=(B, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    write_mrc(str(d / "stack.mrcs"), rng.normal(size=(B, N, N)).astype(
        np.float32), voxel_size=1.32)
    t = make_table(
        B, particle_paths=[f"{i + 1}@{d}/stack.mrcs" for i in range(B)],
        quat_0=q[:, 0], quat_1=q[:, 1], quat_2=q[:, 2], quat_3=q[:, 3],
        translation_x=rng.normal(0, 1, B), translation_y=rng.normal(0, 1, B),
        voltage=np.full(B, 300e3), defocus_u=rng.uniform(1e4, 2e4, B),
        defocus_v=rng.uniform(1e4, 2e4, B), cs=np.full(B, 2.7e7),
        amplitude_contrast=np.full(B, 0.1), class_id=np.arange(B) % 4)
    write_thu(str(d / "poses.thu"), t)
    write_mrc(str(d / "classes.mrcs"), rng.normal(size=(4, N, N)).astype(
        np.float32), voxel_size=2.0)
    return d


def _both(inputs, tmp_path, capsys, argv):
    """Run ``argv`` (a function of the output directory) through both
    CLIs; returns ((JAX dir, printed), (port dir, printed))."""
    out = []
    for name, cli in (("j", jcli), ("t", tcli)):
        d = tmp_path / name
        d.mkdir()
        cli(["--cpu"] + [str(a) for a in argv(d)])
        out.append((d, capsys.readouterr().out))
    return out


def _maps(j, t, name):
    (jd, _), (td, _) = j, t
    a, ha = read_mrc(str(jd / name), return_header=True)
    b, hb = read_mrc(str(td / name), return_header=True)
    assert a.shape == b.shape and ha.voxel_size == pytest.approx(
        hb.voxel_size, rel=1e-6)
    return a, b


# subcommand -> (argv given the input and output directories, output file,
# relative tolerance of the output map; 0 = exact, with equal printed lines)
TOOLS = {
    "project": (lambda i, d: ["project", i / "phantom.mrc", i / "poses.thu",
                              d / "out.mrcs", "--pixel-size", "1.32",
                              "--noise", "0.5", "--seed", "3"],
                "out.mrcs", 1e-5),
    "reconstruct": (lambda i, d: ["reconstruct", i / "poses.thu",
                                  d / "out.mrc", "--pixel-size", "1.32"],
                    "out.mrc", 1e-4),
    "genmask": (lambda i, d: ["genmask", i / "phantom.mrc", d / "out.mrc"],
                "out.mrc", 0),
    "genmask_threshold": (lambda i, d: ["genmask", i / "phantom.mrc",
                                        d / "out.mrc", "--threshold", "0.3",
                                        "--extend", "2", "--edge", "3"],
                          "out.mrc", 0),
    "genmask_shell": (lambda i, d: ["genmask_shell", d / "out.mrc",
                                    "--boxsize", N, "--inner-radius", "4",
                                    "--outer-radius", "12", "--edgewidth",
                                    "3", "--pixelsize", "1.32"],
                      "out.mrc", 1e-5),
    "lowpass": (lambda i, d: ["lowpass", i / "phantom.mrc", d / "out.mrc",
                              "--resolution", "5"], "out.mrc", 1e-5),
    "bfactor": (lambda i, d: ["bfactor", i / "phantom.mrc", d / "out.mrc",
                              "--bfactor", "200"], "out.mrc", 1e-5),
    "mask": (lambda i, d: ["mask", i / "phantom.mrc", i / "half_a.mrc",
                           d / "out.mrc"], "out.mrc", 0),
    "average": (lambda i, d: ["average", i / "half_a.mrc", i / "half_b.mrc",
                              d / "out.mrc"], "out.mrc", 0),
    "minus": (lambda i, d: ["minus", i / "half_a.mrc", i / "half_b.mrc",
                            d / "out.mrc"], "out.mrc", 0),
    "resize_down": (lambda i, d: ["resize", i / "phantom.mrc", d / "out.mrc",
                                  "--size", "16"], "out.mrc", 1e-5),
    "resize_up": (lambda i, d: ["resize", i / "phantom.mrc", d / "out.mrc",
                                "--size", "32"], "out.mrc", 1e-5),
    "alignz": (lambda i, d: ["alignz", i / "phantom.mrc", d / "out.mrc",
                             "--axis", "1,2,3"], "out.mrc", 1e-5),
}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_map_tools(tool, inputs, tmp_path, capsys):
    argv, name, tol = TOOLS[tool]
    j, t = _both(inputs, tmp_path, capsys, lambda d: argv(inputs, d))
    a, b = _maps(j, t, name)
    assert np.isfinite(b).all()
    if tol:
        assert rel_err(b, a) < tol
    else:
        np.testing.assert_array_equal(b, a)
    assert j[1].replace(str(j[0]), "") == t[1].replace(str(t[0]), "")


def test_postprocess(inputs, tmp_path, capsys, monkeypatch):
    """With the JAX package's phase fields the map, the FSC table and the
    printed resolution agree (the B-factor to its first decimal)."""
    ka, kb = jax.random.split(jax.random.PRNGKey(0))
    phases = [tt(jax.random.uniform(k, (N, N, N), minval=0.0,
                                    maxval=2 * jnp.pi, dtype=jnp.float32))
              for k in (ka, kb)]
    monkeypatch.setattr(tpost, "phase_fields", lambda seed, n, dev: phases)
    j, t = _both(inputs, tmp_path, capsys, lambda d: [
        "postprocess", inputs / "half_a.mrc", inputs / "half_b.mrc",
        d / "out.mrc", "--fsc", d / "fsc.txt"])
    a, b = _maps(j, t, "out.mrc")
    assert rel_err(b, a) < 1e-4
    fj = np.loadtxt(j[0] / "fsc.txt")
    ft = np.loadtxt(t[0] / "fsc.txt")
    assert fj.shape == ft.shape == (N // 2, 4)
    np.testing.assert_allclose(ft, fj, atol=1e-4)
    assert j[1].split("B-factor")[0] == t[1].split("B-factor")[0]


def test_view(inputs, tmp_path, capsys):
    j, t = _both(inputs, tmp_path, capsys, lambda d: [
        "view", inputs / "phantom.mrc", "--slices", d / "s"])
    assert j[1].replace(str(j[0]), "") == t[1].replace(str(t[0]), "")
    for name in ("s_xy.bmp", "s_xz.bmp", "s_yz.bmp"):
        assert (j[0] / name).read_bytes() == (t[0] / name).read_bytes()


def test_select(inputs, tmp_path, capsys):
    j, t = _both(inputs, tmp_path, capsys, lambda d: [
        "select", inputs / "classes.mrcs", d / "gallery.html", "--thu",
        inputs / "poses.thu", "--keep", "0,2-3", "--keep-output",
        d / "kept.thu", "--sort"])
    assert (j[0] / "gallery.html").read_text() == \
        (t[0] / "gallery.html").read_text()
    assert (j[0] / "kept.thu").read_bytes() == (t[0] / "kept.thu").read_bytes()
    assert len(read_thu(str(t[0] / "kept.thu"))) == 15
    assert j[1].replace(str(j[0]), "") == t[1].replace(str(t[0]), "")


def test_star_converters(inputs, tmp_path, capsys):
    j, t = _both(inputs, tmp_path, capsys, lambda d: [
        "thu2star", inputs / "poses.thu", d / "poses.star"])
    assert (j[0] / "poses.star").read_bytes() == \
        (t[0] / "poses.star").read_bytes()
    star = j[0] / "poses.star"
    (tmp_path / "back").mkdir()
    j, t = _both(inputs, tmp_path / "back", capsys, lambda d: [
        "star2thu", star, d / "back.thu"])
    assert (j[0] / "back.thu").read_bytes() == (t[0] / "back.thu").read_bytes()
    assert j[1].replace(str(j[0]), "") == t[1].replace(str(t[0]), "")


def test_every_subcommand_is_ported():
    """The port's parser has the JAX package's subcommands and flags."""
    import argparse

    def parsers(main):
        seen = {}
        orig = argparse.ArgumentParser.parse_args

        def grab(self, argv=None, namespace=None):
            sub = next(a for a in self._actions
                       if isinstance(a, argparse._SubParsersAction))
            for name, p in sub.choices.items():
                seen[name] = sorted(
                    o for a in p._actions for o in a.option_strings)
            raise SystemExit(0)
        argparse.ArgumentParser.parse_args = grab
        try:
            with pytest.raises(SystemExit):
                main(["view", "x"])
        finally:
            argparse.ArgumentParser.parse_args = orig
        return seen

    jp, tp = parsers(jcli), parsers(tcli)
    assert len(jp) == 17 and tp == jp


@pytest.mark.parametrize("launcher", ["jax", "torchrun"])
def test_run_joins_a_multi_process_launch(launcher, tmp_path):
    """``python -m thunder_tpu_torch.cli --cpu run`` started as two ranks
    under the JAX package's launch variables or under torchrun's joins one
    gloo group on the JAX package's (2, 1) layout: each rank reads its own
    hemisphere's images (rank r hemisphere r), the two run one round and
    the final round together, rank 0 alone prints the history and writes
    the run's files, and both log to the one thunder.log."""
    from thunder_tpu.io.thu import ThuColumns

    from test_torch_dataset_run import B as N_IMG
    from test_torch_dataset_run import _config, _write_dataset

    _write_dataset(tmp_path)
    cfg = tmp_path / "one.json"
    cfg.write_text(json.dumps(_config(tmp_path, tmp_path / "out",
                                      tmp_path / "particles.thu", iters=1)))
    if launcher == "jax":
        envs = lambda port: [rank_env(
            JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
            JAX_NUM_PROCESSES=2, JAX_PROCESS_ID=r) for r in range(2)]
    else:
        envs = lambda port: [rank_env(
            MASTER_ADDR="localhost", MASTER_PORT=port, WORLD_SIZE=2, RANK=r,
            LOCAL_RANK=r, LOCAL_WORLD_SIZE=2) for r in range(2)]
    argv = [sys.executable, "-m", "thunder_tpu_torch.cli", "--cpu", "run",
            str(cfg)]
    outs = run_ranks_on_a_port([argv, argv], envs, str(tmp_path),
                               timeout=240)
    for r, out in enumerate(outs):
        assert (f"rank {r} of 2: backend gloo, device cpu, mesh "
                f"{{'half': 2, 'data': 1}}, coordinates (half {r}, data 0)"
                ) in out, out
    history = [json.loads(x) for x in outs[0].splitlines()
               if x.startswith("{")]
    assert [h["iter"] for h in history] == [1]
    # the ranks' references and FSC before rank 0's broadcast were rank
    # 0's bits, and the summed insert table held every rank's total
    gaps = history[0]["rank_gaps"]
    assert gaps["refs"] == gaps["fsc"] == [0.0, 0.0], gaps
    assert max(gaps["T"]) <= 2 * 2.0 ** -22, gaps
    assert not any(x.startswith("{") for x in outs[1].splitlines())
    meta = read_thu(str(tmp_path / "out" / "Meta_Final.thu"))
    assert len(meta) == N_IMG
    assert np.isfinite(meta.values[:, ThuColumns.COORDINATE_X:]).all()
    log = (tmp_path / "out" / "thunder.log").read_text()
    for r in range(2):
        assert f"[host {r}]" in log
    assert log.count(f"this host loaded {N_IMG // 2} local slices") == 2
    assert "round 1: the 2 ranks agree" in log
