"""A/B of the int8 YOLOv3 glue: the product's int8 forward against an int8 chain.

    python -m poserisk_release_tpu_torch.tools.exp_int8_glue [batch] [--cpu]

The counterpart of the JAX repo's tools/exp_int8_glue.py, on B (128)
uniform uint8 450x800 frames drawn on the card, rect-letterboxed (416) in
bf16, with the seed-0 YOLOv3 BN-folded:

  A  the product's int8 forward (models/detector.yolo_forward over the
     quantize_yolo_params tower: each ops/qconv conv quantizes its bf16
     input, multiplies in int8 and writes bf16 through its epilogue)
  B  the int8-chain prototype (build_chain_params, make_chain_forward):
     every tower tensor is int8 with a static scale, each conv's epilogue
     folds dequant + bias + leaky + requant into one s32 -> s8 step (A =
     s_in * w_scale / s_out, B = bias / s_out; leaky is positively
     homogeneous), shortcuts add in the int8 domain with each operand
     rescaled, route concats rescale their parts to the consumer's scale.
     Its int8 products are ops/qconv's (torch._int_mm on the card, the
     exact float64 product on the CPU). The three detection heads stay
     float: per-tensor int8 on their wide-range inputs blows up the
     exp(wh) decode.

Prints the max score and relative box deltas on 4 frames between the
chain, A and the f32 forward (on these random weights the heads decode
boxes of ~1e11 px and saturated scores, so any change to a head's input
moves both by their whole range: A against f32 differs as much as the
chain against A), each arm's host ms (24 enqueued calls, one readback, the
faster of two interleaved passes) with its device ms, and, in place of the
JAX tool's HLO dump, a torch.profiler table of the kernels one call of each
arm launches. On the card it also holds the chain's card branch (im2col +
torch._int_mm, head rows padded) against its plain branch on the CPU on 2
frames: every int8 tensor equal, detections within DET_RTOL. Runs on the
card unless --cpu is given.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import numpy as np
import torch

from poserisk_release_tpu_torch.tools import ab

# The card's decode (sigmoid, exp) against the CPU's, relative to max(1, |x|).
DET_RTOL = 1e-5


def _spec(spec):
    from poserisk_release_tpu_torch.models.detector import YOLOV3_SPEC

    return YOLOV3_SPEC if spec is None else spec


def _conv_f32(x: torch.Tensor, layer: Dict, entry: tuple) -> torch.Tensor:
    """One float spec conv, NHWC, with its folded bias (+ leaky)."""
    import torch.nn.functional as F

    from poserisk_release_tpu_torch.ops.qconv import leaky

    _, _filters, ksize, stride, bn = entry
    kernel = torch.as_tensor(layer["kernel"], device=x.device).permute(3, 2, 0, 1)
    bias = torch.as_tensor(layer["folded_bias_leaky" if bn else "conv_bias"], device=x.device)
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel, bias, stride, (ksize - 1) // 2)
    return (leaky(y) if bn else y).permute(0, 2, 3, 1)


def _upsample(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x on NHWC."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def calibrate_entry_outputs(folded: Dict, letterboxed: torch.Tensor, spec=None) -> Dict:
    """The absmax of EVERY spec entry's output in one f32 walk (the chain
    needs output scales for shortcut operands too, which
    calibrate_yolo_activations does not record), plus "input", the
    letterbox's. folded: the JAX-layout params (models/convert.
    state_dict_to_yolo_params); letterboxed (B, H, W, 3) f32."""
    spec = _spec(spec)
    absmax = {}
    outputs = []
    x = letterboxed
    with torch.no_grad():
        for i, entry in enumerate(spec):
            kind = entry[0]
            if kind == "conv":
                x = _conv_f32(x, folded[f"conv_{i}"], entry)
            elif kind == "shortcut":
                x = x + outputs[i + entry[1]]
            elif kind == "route":
                parts = [outputs[r if r >= 0 else i + r] for r in entry[1]]
                x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
            elif kind == "upsample":
                x = _upsample(x)
            elif kind == "yolo":
                outputs.append(x)
                continue
            outputs.append(x)
            absmax[str(i)] = float(x.abs().max())
    absmax["input"] = float(letterboxed.abs().max())
    return absmax


def build_chain_params(folded: Dict, out_absmax: Dict, spec=None):
    """(params, scales): per conv {qkernel HWIO int8, A, B} (leaky convs)
    or {qkernel, deq, bias} (the float heads), numpy, and the static scale
    of every entry's int8 output (None after a float head), as the JAX
    tool builds them."""
    spec = _spec(spec)
    params, scales = {}, {}
    in_scale = max(out_absmax["input"], 1e-12) / 127.0
    scales["input"] = in_scale
    prev_scale = in_scale
    channels = []
    in_ch = 3
    for i, entry in enumerate(spec):
        kind = entry[0]
        if kind == "conv":
            _, filters, _ksize, _stride, bn = entry
            layer = folded[f"conv_{i}"]
            kernel = np.asarray(layer["kernel"], np.float32)
            w_scale = np.maximum(np.abs(kernel).max(axis=(0, 1, 2)), 1e-12) / 127.0
            qk = np.clip(np.round(kernel / w_scale), -127, 127).astype(np.int8)
            if bn:
                s_out = max(out_absmax[str(i)], 1e-12) / 127.0
                params[f"conv_{i}"] = {
                    "qkernel": qk,
                    "A": (prev_scale * w_scale / s_out).astype(np.float32),
                    "B": (np.asarray(layer["folded_bias_leaky"], np.float32)
                          / s_out).astype(np.float32)}
                scales[i] = prev_scale = s_out
            else:
                params[f"conv_{i}"] = {
                    "qkernel": qk, "deq": (prev_scale * w_scale).astype(np.float32),
                    "bias": np.asarray(layer["conv_bias"], np.float32)}
                scales[i] = prev_scale = None
            in_ch = filters
        elif kind in ("shortcut", "route"):
            s_out = max(out_absmax[str(i)], 1e-12) / 127.0
            scales[i] = prev_scale = s_out
            if kind == "route":
                in_ch = sum(channels[r if r >= 0 else i + r] for r in entry[1])
        else:  # upsample, yolo
            scales[i] = prev_scale
        channels.append(in_ch)
    return params, scales


def chain_params_to_device(params: Dict, device) -> Dict:
    """build_chain_params' numpy params as tensors on the device, each
    conv with the GEMM matrix of its kernel (the card's product; its rows
    zero-padded to a multiple of 8, which torch._int_mm takes, for the
    heads' 255 channels) and its OIHW copy (the CPU's)."""
    from poserisk_release_tpu_torch.ops.qconv import weight_matrix

    out = {}
    for name, layer in params.items():
        qk = layer["qkernel"]
        conv = {k: torch.as_tensor(v, device=device) for k, v in layer.items() if k != "qkernel"}
        wmat = weight_matrix(qk)
        conv["wmat"] = torch.as_tensor(np.pad(wmat, ((0, -wmat.shape[0] % 8), (0, 0))),
                                       device=device)
        conv["qkernel"] = torch.as_tensor(np.ascontiguousarray(qk.transpose(3, 2, 0, 1)),
                                          device=device)
        conv["shape"] = qk.shape[:2]
        out[name] = conv
    return out


def sat8(x: torch.Tensor) -> torch.Tensor:
    """clip(round(x), -127, 127) as int8 (round half-to-even)."""
    return torch.clamp(torch.round(x), -127.0, 127.0).to(torch.int8)


def _int_conv(x: torch.Tensor, layer: Dict, stride: int, pad: int,
              gemm: bool | None = None) -> torch.Tensor:
    """s8 NHWC x s8 kernel -> the exact sums as f32 NHWC: ops/qconv's
    product, im2col + torch._int_mm (gemm; the default on the card) or the
    float64 conv (the CPU's)."""
    from poserisk_release_tpu_torch.ops.qconv import int_conv_nhwc, int_conv_plain

    kh, kw = layer["shape"]
    if x.device.type == "cuda" if gemm is None else gemm:
        acc = int_conv_nhwc(x.contiguous(), layer["wmat"], kh, kw, stride, pad)
        acc = acc[..., :layer["qkernel"].shape[0]]
    else:
        acc = int_conv_plain(x.permute(0, 3, 1, 2), layer["qkernel"], stride, pad).permute(
            0, 2, 3, 1)
    return acc.to(torch.float32)


def make_chain_forward(scales: Dict, spec=None, gemm: bool | None = None):
    """fwd(params, letter_q8 (B, H, W, 3) int8, tap=None) -> (B, anchors,
    5) f32 detections of the int8 chain; params from
    chain_params_to_device; gemm as _int_conv takes it. tap(i, x), when
    given, sees every int8 tensor the chain makes (entry i's output, in
    order)."""
    from poserisk_release_tpu_torch.models.detector import _decode_head
    from poserisk_release_tpu_torch.ops.qconv import leaky

    spec = _spec(spec)

    def fwd(params, letter_q8, tap=None):
        def made(i, t):
            if tap is not None:
                tap(i, t)
            return t

        outputs, detections = [], []
        x = letter_q8
        for i, entry in enumerate(spec):
            kind = entry[0]
            if kind == "conv":
                _, _filters, ksize, stride, _bn = entry
                layer = params[f"conv_{i}"]
                y32 = _int_conv(x, layer, stride, (ksize - 1) // 2, gemm)
                if "A" in layer:
                    x = made(i, sat8(leaky(y32 * layer["A"] + layer["B"])))
                else:
                    x = y32 * layer["deq"] + layer["bias"]
            elif kind == "shortcut":
                j = i + entry[1]
                s1, s2, s_out = scales[i - 1], scales[j], scales[i]
                x = made(i, sat8(x.to(torch.float32) * (s1 / s_out)
                                 + outputs[j].to(torch.float32) * (s2 / s_out)))
            elif kind == "route":
                s_out = scales[i]
                parts = []
                for r in (r if r >= 0 else i + r for r in entry[1]):
                    p = outputs[r]
                    parts.append(p if scales[r] == s_out
                                 else sat8(p.to(torch.float32) * (scales[r] / s_out)))
                x = made(i, parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1))
            elif kind == "upsample":
                x = _upsample(x)
            elif kind == "yolo":
                stride = letter_q8.shape[1] // x.shape[1]
                detections.append(_decode_head(x.permute(0, 3, 1, 2), entry[1], stride))
            outputs.append(x)
        return torch.cat(detections, dim=1)

    return fwd


def card_against_plain(params: Dict, scales: Dict, letter_q8: torch.Tensor,
                       spec=None) -> dict:
    """The chain's card branch on letter_q8's device (ops/qconv's im2col +
    torch._int_mm, the heads' GEMM rows padded to 8) against its plain
    branch on the CPU (the exact float64 product). params:
    build_chain_params' numpy params. Returns the int8 tensors compared,
    the elements that differ (must be 0) and the detections' max error
    relative to max(1, |plain|)."""
    plain = []
    with torch.inference_mode():
        want = make_chain_forward(scales, spec, gemm=False)(
            chain_params_to_device(params, "cpu"),
                                          letter_q8.cpu(), tap=lambda i, t: plain.append(t))
        seen = {"tensors": 0, "differ": 0}

        def compare(i, t):
            ref = plain[seen["tensors"]]
            seen["tensors"] += 1
            seen["differ"] += (int((t.cpu() != ref).sum()) if t.shape == ref.shape
                               else ref.numel())

        got = make_chain_forward(scales, spec, gemm=True)(
            chain_params_to_device(params, letter_q8.device), letter_q8, tap=compare).cpu()
    err = float(((got - want).abs() / want.abs().clamp(min=1.0)).max())
    return {"int8_tensors": seen["tensors"], "int8_tensors_plain": len(plain),
            "int8_elements_differing": seen["differ"], "det_max_rel_err": err,
            "ok": bool(seen["tensors"] == len(plain) and seen["differ"] == 0
                       and err <= DET_RTOL)}


def deltas(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """Max score delta and max box delta relative to max(1, |b|) of two
    (B, anchors, 5) detections."""
    a, b = a.float(), b.float()
    ds = float((a[..., 4] - b[..., 4]).abs().max())
    db = float(((a[..., :4] - b[..., :4]).abs() / b[..., :4].abs().clamp(min=1.0)).max())
    return ds, db


def kernel_table(fn, device, rows: int = 12) -> dict:
    """torch.profiler over one fn() call: the device kernels it launches
    (on the card; the CPU ops elsewhere), printed as a table."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch.inference_mode(), profile(activities=acts) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize(device)
    events = prof.key_averages()
    sort = "cuda_time_total" if cuda else "cpu_time_total"
    print(events.table(sort_by=sort, row_limit=rows), flush=True)
    if cuda:
        kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        return {"kernels": sum(e.count for e in kernels), "distinct": len(kernels)}
    return {"kernels": None, "cpu_ops": sum(e.count for e in events)}


def int8_glue_ab(device, batch: int = ab.B, passes: int = ab.PASSES,
                 measure: int = ab.MEASURE) -> dict:
    """Deltas, times and kernel tables of both arms; returns the record."""
    from poserisk_release_tpu_torch.models.convert import state_dict_to_yolo_params
    from poserisk_release_tpu_torch.models.detector import quantize_yolo_params, yolo_forward
    from poserisk_release_tpu_torch.ops.crop import letterbox_device_rect
    from poserisk_release_tpu_torch.tools.profile_stages import tf32_off

    k0 = ab.launches()
    frames = ab.uniform_frames(device, batch)
    with torch.inference_mode():
        letter = letterbox_device_rect(frames, 416, out_dtype=torch.bfloat16)
    folded = ab.folded_yolo()
    calib = letter[:16].float()
    product = ab.yolo_module(quantize_yolo_params(folded, ab.yolo_absmax(folded, calib)), device)
    jax_layout = state_dict_to_yolo_params(folded)
    params, scales = build_chain_params(jax_layout, calibrate_entry_outputs(jax_layout, calib))
    chain = make_chain_forward(scales)
    with torch.inference_mode():
        letter_q8 = sat8(letter.float() * (1.0 / scales["input"]))
    check = card_against_plain(params, scales, letter_q8[:2]) if device.type == "cuda" else None
    if check is not None:
        print(f"chain on the card vs its plain version: {check}", flush=True)
    params = chain_params_to_device(params, device)
    with torch.inference_mode(), tf32_off():
        cur = yolo_forward(product, letter[:4])
        chn = chain(params, letter_q8[:4])
        ref = yolo_forward(ab.yolo_module(folded, device), letter[:4].float())
    ds, db = deltas(chn, cur)
    vs_f32 = {"current": deltas(cur, ref), "chain": deltas(chn, ref)}
    print(f"chain-vs-current: max score delta {ds:.4f}, max rel box delta {db:.4g}; against "
          f"f32: current {vs_f32['current'][0]:.4f}, {vs_f32['current'][1]:.4g}, chain "
          f"{vs_f32['chain'][0]:.4f}, {vs_f32['chain'][1]:.4g}", flush=True)
    arms = {"A current int8 (bf16 glue)": lambda: yolo_forward(product, letter)[..., 4],
            "B int8-chain": lambda: chain(params, letter_q8)[..., 4]}
    times = ab.interleaved(arms, device, passes, measure)
    rows = []
    for name, t in times.items():
        print(f"{name}: {t['host_ms']:.2f} ms / {batch} frames host, {t['ms']:.2f} device "
              f"({batch / t['host_ms'] * 1e3:.1f} fps)", flush=True)
        print(f"kernels of one call of {name}:")
        rows.append({"arm": name, "fps": batch / t["host_ms"] * 1e3,
                     "profile": kernel_table(arms[name], device), **t})
    a, b = (t["host_ms"] for t in times.values())
    print(f"speedup B vs A: {a / b:.3f}x", flush=True)
    rec = ab.record("exp_int8_glue", device, rows, k0, batch=batch, score_delta=ds,
                    rel_box_delta=db, vs_f32=vs_f32, card_vs_plain=check, speedup=a / b)
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("batch", type=int, nargs="?", default=ab.B)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    args = ap.parse_args(argv)
    return int8_glue_ab(ab.tool_device(args.cpu), args.batch)


if __name__ == "__main__":
    main()
