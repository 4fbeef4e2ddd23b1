"""The frozen counts against published and hand-summed figures."""

import os

import pytest

from conftest import ROOT
from portbench import counts
from portbench.model import load_config


def config(name):
    return load_config(os.path.join(ROOT, "portbench", "configs",
                                    name + ".json"))


def test_vgg16_forward_is_the_published_15_5_gmac():
    model = config("vgg16")
    macs = counts.forward_flops(model) / 2
    assert macs == pytest.approx(15.5e9, rel=0.005)
    assert model.parameters == model.config["parameters"] == 138357544


def test_alexnet_forward_is_the_hand_sum_of_its_eight_layers():
    macs = (55 * 55 * 96 * 11 * 11 * 3 + 27 * 27 * 256 * 5 * 5 * 96 +
            13 * 13 * 384 * 3 * 3 * 256 + 13 * 13 * 384 * 3 * 3 * 384 +
            13 * 13 * 256 * 3 * 3 * 384 + 9216 * 4096 + 4096 * 4096 +
            4096 * 1000)
    model = config("alexnet")
    assert counts.forward_flops(model) == 2 * macs
    assert model.parameters == model.config["parameters"]


@pytest.mark.parametrize("name", ["vgg16", "alexnet"])
def test_train_step_is_forward_dw_and_dx_but_the_first_layers(name):
    model = config(name)
    first = counts.layer_flops(model.layers[0])
    assert counts.train_flops(model) == 3 * counts.forward_flops(
        model) - first


def test_kernel_bounds_at_known_shapes():
    peaks = counts.load_peaks()
    vgg = config("vgg16")
    # five pools at batch 32: 0.585 ms, the byte bound of earlier runs
    assert counts.max_pool_bwd_bound_s(vgg, 32, peaks) == pytest.approx(
        0.585e-3, rel=0.01)
    # the int8 products of a rung-32 dispatch: 1.36 ms
    assert counts.matmul_int8_bound_s(vgg, 32, peaks) == pytest.approx(
        1.36e-3, rel=0.01)
    # conv1_2 at batch 64 is bound by its bytes, conv5_1 by its work
    rate, bw = peaks["ops_per_s"]["bfloat16"], peaks["hbm_bytes_per_s"]
    conv12 = vgg.layers[1]
    nbytes = 4 * 64 * (224 * 224 * 64 * 4) + 4 * (3 * 3 * 64 * 64 + 64)
    assert nbytes / bw > 64 * counts.layer_flops(conv12) / rate
    assert counts.conv_wgrad_bound_s(vgg, 64, peaks) > \
        counts.conv_wgrad_bound_s(vgg, 32, peaks)


def test_int8_products_follow_the_table():
    vgg = config("vgg16")
    products = counts.int8_products(vgg, 8)
    assert products[0] == (8 * 224 * 224, 64, 27)
    assert products[-1] == (8, 1000, 4096)
    assert len(products) == 16
