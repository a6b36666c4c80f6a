"""Port parity: configuration (thunder_tpu_torch.config.Para)."""

import dataclasses
import glob
import os

import pytest

from thunder_tpu import config as jconfig
from thunder_tpu_torch import config as tconfig
from thunder_tpu_torch.dtypes import resolve_device

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")


def test_para_fields_and_defaults_match():
    jf = {f.name: f.default for f in dataclasses.fields(jconfig.Para)}
    tf = {f.name: f.default for f in dataclasses.fields(tconfig.Para)}
    assert jf == tf


@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(CONFIG_DIR, "demo*.json"))))
def test_demo_configs_carry_over(path):
    jp = jconfig.load_para(path)
    tp = tconfig.Para(**dataclasses.asdict(jp))
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert tp.mask_radius_px == pytest.approx(jp.mask_radius_px)


def test_entry_points_default_to_cuda():
    assert resolve_device(None).type == "cuda"
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("field,value", [
    ("fused_kernels", "off"), ("fused_kernels", "interpret"),
    ("insert_impl", "scatter"), ("insert_impl", "sorted")])
def test_optimiser_refuses_backend_choices(field, value):
    """The port picks its kernels by device; a JAX backend choice it would
    not honour is refused, not silently replaced."""
    from thunder_tpu_torch.core.optimiser import Optimiser

    para = tconfig.Para(size=32, sym="C4", **{field: value})
    with pytest.raises(ValueError, match=field):
        Optimiser(para, device="cpu")


@pytest.mark.parametrize("path", sorted(glob.glob(
    os.path.join(CONFIG_DIR, "demo*.json"))))
def test_load_para_matches_field_by_field(path):
    """The port's own JSON loader reads every demo configuration as the
    JAX package's does, mode-dependent sampling keys included."""
    jp, tp = jconfig.load_para(path), tconfig.load_para(path)
    for f in dataclasses.fields(jconfig.Para):
        assert getattr(tp, f.name) == getattr(jp, f.name), f.name


def test_load_para_mode_keys():
    """2D files take the (2D) sampling keys, 3D files the (3D) ones."""
    p2 = tconfig.load_para(os.path.join(CONFIG_DIR, "demo_2D.json"))
    p3 = tconfig.load_para(os.path.join(CONFIG_DIR, "demo_3D.json"))
    assert (p2.mode, p2.k, p2.m_s, p2.m_l_r) == ("2d", 30, 100, 9)
    assert (p3.mode, p3.k, p3.m_s, p3.m_l_r) == ("3d", 4, 10000, 125)


@pytest.mark.parametrize("src", [
    {"Basic": {"Number of Clases": 4}},
    {"Basics": {"Number of Classes": 4}},
    {"Advanced": {"Padding Factor": 2, "Paddding Factor": 3}}])
def test_check_keys_rejects_unknown_keys(src):
    """An unknown key (or section) raises under ``strict`` and warns
    otherwise, naming the key, as in the JAX package."""
    with pytest.raises(KeyError) as jerr:
        jconfig.load_para(src, strict=True)
    with pytest.raises(KeyError) as terr:
        tconfig.load_para(src, strict=True)
    assert str(terr.value) == str(jerr.value)
    with pytest.warns(UserWarning):
        unknown = tconfig.check_keys(src)
    with pytest.warns(UserWarning):
        assert unknown == jconfig.check_keys(src)
    assert len(unknown) == 1
