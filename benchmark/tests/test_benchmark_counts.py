"""The frozen counts on hand-worked shapes, and the kernel classes."""

from __future__ import annotations

import json

import pytest

from benchmark import families, flops, kernel_classes, roofline, spec
from benchmark.families import llama, moe


def _model(name):
    config = json.loads((spec.HERE / "configs" / f"{name}.json").read_text())
    return families.load(config["family"]).sizes(config)


def test_causal_pairs():
    assert flops.causal_pairs(1) == 1
    assert flops.causal_pairs(4) == 10  # 4 + 3 + 2 + 1
    assert flops.causal_pairs(4096) == 4096 * 4097 // 2


def test_dense_count_by_hand():
    m = llama.Model(family="llama", vocab=10, dim=8, n_layers=1, n_heads=2,
                    n_kv_heads=1, head_dim=4, ffn=16, eps=1e-5, rope_theta=1e4)
    B, S = 1, 3
    qkvo = 2 * 3 * 8 * 8 * 2 + 2 * 3 * 8 * 4 * 2  # q, o and the narrow k, v
    attn = 2 * 2 * 2 * 4 * 6  # two products, 2 heads, D 4, 6 causal pairs
    ffn = 6 * 3 * 8 * 16
    unembed = 2 * 3 * 8 * 10
    assert llama.forward_flops(m, B, S) == qkvo + attn + ffn + unembed
    assert llama.train_flops_per_step(m, B, S) == 3 * (qkvo + attn + ffn + unembed)


@pytest.mark.parametrize("name,seq,per_token", [
    ("mistral-7b", 4096, 12.06e9), ("mistral-7b", 1024, 11.46e9),
    ("mixtral-8x7b", 4096, 5.72e9)])
def test_cells_per_token(name, seq, per_token):
    m = _model(name)
    got = families.of(m).train_flops_per_step(m, 1, seq) / seq
    assert got == pytest.approx(per_token, rel=2e-3)


def test_moe_counts_top_k_and_router_only():
    m = _model("mixtral-8x7b")
    dense = llama.Model(**{**m.__dict__, "family": "llama", "n_experts": 0,
                           "top_k": 0})
    diff = moe.forward_flops(m, 1, 16) - llama.forward_flops(dense, 1, 16)
    per_layer = 6 * 16 * 4096 * 14336 * (2 - 1) + 2 * 16 * 4096 * 8
    assert diff == m.n_layers * per_layer


def test_attention_work_by_hand():
    B, H, KV, S, D = 1, 2, 1, 4, 8
    f, b = roofline.attn_fwd_work(B, H, KV, S, D)
    assert f == 2 * 2 * B * H * D * 10
    assert b == 2 * (64 + 2 * 32 + 64) + 4 * 8
    f, b = roofline.attn_bwd_work(B, H, KV, S, D)
    assert f == 5 * 2 * B * H * D * 10
    assert b == 2 * (3 * 64 + 2 * 32) + 4 * 8 + 2 * (64 + 2 * 32)


def test_least_seconds_and_peaks():
    assert roofline.peak(roofline.PEAK_BF16_FLOPS, "NVIDIA H100 80GB HBM3") == 989e12
    assert roofline.peak(roofline.PEAK_HBM_BYTES, "NVIDIA H100 PCIe") == 2.0e12
    assert roofline.peak(roofline.PEAK_BF16_FLOPS, "cpu") is None
    assert roofline.least_seconds((989e12, 1.0), 989e12, 3.35e12) == 1.0
    assert roofline.least_seconds((1.0, 3.35e12), 989e12, 3.35e12) == 1.0


@pytest.mark.parametrize("name,span,cls", [
    ("void fwd::fwd_kernel<128, 128, 128>(fwd::Params)", None, "attention"),
    ("void dq::dq_kernel<128, 128, 64>(dq::Params)", None, "attention"),
    ("void dkv::dkv_kernel<128, 0, 128, 32>(dkv::Params)", None, "attention"),
    ("void at::native::reduce_kernel<512, 1>(...)", "bench.attn_bwd", "attention"),
    ("nvjet_tst_256x128_64x4_2x1_v_bz_coopB_TNN", None, "matmul"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n", None, "matmul"),
    ("cutlass::Kernel2<cutlass_80_tensorop_s1688gemm>", None, "matmul"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)", None, "nccl"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", None, "elementwise"),
    ("void at::native::reduce_kernel<512, 1, ...>", None, "elementwise"),
    ("Memcpy HtoD (Pageable -> Device)", None, "memory"),
    ("Memset (Device)", None, "memory"),
    ("void at_cuda_detail::cub::DeviceScanKernel<...>", None, "scan"),
    ("void at::native::(anonymous namespace)::multi_tensor_apply_kernel<...>", None, "elementwise"),
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float>", None, "elementwise"),
    ("void (anonymous namespace)::indexing_backward_kernel<c10::BFloat16, 4>", None, "elementwise"),
    ("void at::native::tensor_kernel_scan_outer_dim<float, unsigned int>", None, "scan"),
    ("void (anonymous namespace)::softmax_warp_forward<float, float>", None, "elementwise"),
    ("void some_new_kernel<float>", None, "other"),
])
def test_kernel_classes(name, span, cls):
    assert kernel_classes.classify(name, span) == cls
