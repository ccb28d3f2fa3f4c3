"""Percentiles are taken over all requests, failures entering as +inf, the
rate over the window; the work counts match a hand count; the readers
read what they say."""
from __future__ import annotations

import math
import types

import pytest

import perfbench_testlib as lib  # noqa: F401  (puts perfbench on the path)
from harness import spec, stats, work
from harness.devtrace import DeviceTrace, base_name
from harness.serve import Run


def fake_run(records, ws=10.0, we=20.0):
    """A finished run's records without the program: only the fields the
    end-to-end readers use."""
    run = Run.__new__(Run)
    run.records, run.ws, run.we = records, ws, we
    return run


def rec(due, times, failed=None, rid=0):
    return {"rid": rid, "due": due, "sent": due, "times": times,
            "failed": failed}


def test_percentile_over_every_value_with_failures_as_inf():
    assert stats.percentile([1, 2, 3, 4, 5], 50) == 3
    assert stats.percentile([1, 2, 3, 4, 5], 95) == pytest.approx(4.8)
    assert stats.percentile([1, 2, 3, math.inf], 50) == 2.5
    assert stats.percentile([1, 2, 3, math.inf], 95) == math.inf
    assert stats.percentile([], 50) is None


def test_spread_is_the_quartile_distance_over_the_median():
    assert stats.spread([10, 10, 10, 10]) == 0
    vals = [9.0, 10.0, 11.0, 12.0, 10.0, 10.5]
    q1, q2, q3 = __import__("statistics").quantiles(vals, n=4)
    assert stats.spread(vals) == pytest.approx((q3 - q1) / q2)


def test_end_to_end_readers():
    run = fake_run([
        rec(9.0, [9.5, 10.5]),                   # sent before the window
        rec(11.0, [11.1, 11.3, 11.6], rid=1),
        rec(12.0, [12.3, 12.4, 21.0], rid=2),    # last token after it
        rec(13.0, [13.2], failed="not done", rid=3),
    ])
    read = {m: spec.metric_reader(m)(run) for m in
            ("ttft_p50_ms", "ttft_p95_ms", "itl_p95_ms", "output_tok_s")}
    # window requests: due 11, 12, 13 -> ttft 0.1, 0.3, inf
    assert read["ttft_p50_ms"] == pytest.approx(300.0)
    assert read["ttft_p95_ms"] == math.inf
    # gaps 0.2, 0.3, 0.1, 8.6 and the failure's inf
    assert read["itl_p95_ms"] == math.inf
    # tokens inside [10, 20): 10.5, 11.1, 11.3, 11.6, 12.3, 12.4, 13.2
    assert read["output_tok_s"] == pytest.approx(7 / 10)


def test_itl_without_failures():
    run = fake_run([rec(11.0, [11.0, 11.1, 11.4, 11.5])])
    v = spec.metric_reader("itl_p95_ms")(run)
    assert v == pytest.approx(1e3 * stats.percentile([0.1, 0.3, 0.1], 95))


QWEN = {"hidden_size": 8, "intermediate_size": 16, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "vocab_size": 32, "projector_width": 8}
DSV3 = {"hidden_size": 8, "intermediate_size": 16, "num_hidden_layers": 2,
        "num_attention_heads": 2, "num_key_value_heads": 2,
        "vocab_size": 32, "q_lora_rank": 4, "kv_lora_rank": 4,
        "qk_nope_head_dim": 2, "qk_rope_head_dim": 2, "v_head_dim": 2,
        "n_routed_experts": 4, "num_experts_per_tok": 2,
        "n_shared_experts": 1, "moe_intermediate_size": 4,
        "first_k_dense_replace": 1}


def test_work_counts_by_hand_gqa():
    s = work.Shape(QWEN)                # head dim 2
    assert s.hd == 2
    # q 8x4x2 + k, v 2 * 8x2x2 + o 4x2x8 = 64 + 64 + 64, two FLOPs each
    assert s.attn_proj_flops() == 2 * (64 + 64 + 64)
    assert s.ffn_flops() == 2 * 3 * 8 * 16 * 2
    assert work.pairs(3, 3) == 6 and work.pairs(1, 5) == 5
    assert work.pairs(2, 5) == 9
    pre = {"kind": "prefill", "q": [3], "ctx": [3], "nv": 2, "unembed": 1}
    want = (3 * (s.attn_proj_flops() * 2 + s.ffn_flops())
            + 2 * 8 * 32 + 2 * 2 * 8 * 8 * 2 + 4 * 4 * 2 * 6 * 2)
    assert work.model_flops(s, pre) == want
    fl, by = work.flash_work(s, pre)
    assert fl == 4 * 4 * 2 * 6 * 2
    # q and o 3 x 4 x 2, k and v 3 x 2 x 2, bf16, two layers
    assert by == 2 * (2 * 3 * 4 * 2 + 2 * 3 * 2 * 2) * 2
    dec = {"kind": "decode", "q": [1, 1], "ctx": [5, 7], "unembed": 2}
    fl, by = work.paged_work(s, dec)
    assert fl == 4 * 4 * 2 * (5 + 7) * 2
    assert by == 2 * (2 * 12 * 2 * 2 + 2 * 2 * 4 * 2) * 2


def test_work_counts_by_hand_mla_and_experts():
    s = work.Shape(DSV3)
    # one dense layer, then one expert layer at top-2 routed + 1 shared
    assert s.ffn_flops() == (2 * 3 * 8 * 16
                             + 2 * 8 * 4 + 2 * 3 * 8 * 4 * 3)
    dec = {"kind": "decode", "q": [1], "ctx": [6], "unembed": 1}
    fl, by = work.mla_work(s, dec)
    assert fl == 2 * 2 * (6 * 6 + 6 * 4) * 2
    assert by == (2 * 6 * 6 + 4 * 2 * (6 + 4)) * 2
    pre = {"kind": "prefill", "q": [3], "ctx": [3], "unembed": 1}
    fl, by = work.flash_work(s, pre)
    assert fl == 2 * 2 * (4 + 2) * 6 * 2


def test_roofline_reader_is_bound_over_kernel_time():
    s = work.Shape(QWEN)
    call = {"kind": "prefill", "q": [64], "ctx": [64], "nv": 0,
            "unembed": 1, "profiled": True, "wall_s": 1.0}
    ops = [("flash_fwd_kernel", 0, 2000), ("paged_split_kernel", 0, 50)]
    run = types.SimpleNamespace(cfg=QWEN, calls=[call],
                                devtrace=DeviceTrace(ops, [], 0, 5000))
    from harness.peaks import bound_s
    want = 100 * bound_s(*work.flash_work(s, call)) / 2e-6
    assert spec.metric_reader("flash_roofline")(run) == pytest.approx(want)
    assert spec.metric_reader("mla_roofline")(run) is None


def test_kernel_base_names():
    assert base_name("void (anonymous namespace)::flash_fwd_wide_kernel"
                     "<192, 128>(FlashParams)") == "flash_fwd_wide_kernel"
    assert base_name("(anonymous namespace)::tc::mla_tc_kernel(CUtensorMap"
                     "_st, float const*)") == "mla_tc_kernel"
    assert base_name("nvjet_tst_64x8_64x16_2x4_h_bz_NNT") == \
        "nvjet_tst_64x8_64x16_2x4_h_bz_NNT"
    assert base_name("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD"


def test_idle_inside_steps():
    ops = [("k", 100, 300), ("k", 250, 400), ("k", 900, 1000)]
    spans = [("engine_step", 0, 500), ("decode", 200, 500),
             ("engine_step", 800, 1000)]
    t = DeviceTrace(ops, spans, 0, 1000)
    assert t.busy_s == pytest.approx(400e-9)
    # steps 700 ns long, busy 300 + 100 of it
    assert t.idle_share_in_steps() == pytest.approx(1 - 400 / 700)
    gaps = dict(t.idle_gaps(min_ns=1))
    # idle 0-100 and 800-900 in a step outside the model, 400-500 in the
    # decode call, 500-800 between the steps
    assert gaps["in Engine.step, outside the model"] == pytest.approx(
        200e-9)
    assert gaps["in Model.decode"] == pytest.approx(100e-9)
    assert gaps["between engine steps"] == pytest.approx(300e-9)


def test_mfu_readers_split_prompt_calls_from_all():
    s = work.Shape(QWEN)
    pre = {"kind": "prefill", "q": [64], "ctx": [64], "nv": 0,
           "unembed": 1, "wall_s": 1.0}
    dec = {"kind": "decode", "q": [1, 1], "ctx": [65, 9], "unembed": 2,
           "wall_s": 3.0}
    run = types.SimpleNamespace(cfg=QWEN, calls=[pre, dec])
    from harness.peaks import PEAK_FLOPS_BF16
    f_pre, f_dec = work.model_flops(s, pre), work.model_flops(s, dec)
    assert spec.metric_reader("mfu")(run) == pytest.approx(
        100 * (f_pre + f_dec) / (4.0 * PEAK_FLOPS_BF16))
    assert spec.metric_reader("mfu.prefill")(run) == pytest.approx(
        100 * f_pre / PEAK_FLOPS_BF16)
    run.calls = [dec]
    assert spec.metric_reader("mfu.prefill")(run) is None

