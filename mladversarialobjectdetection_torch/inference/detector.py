"""Serving detector (PyTorch).

Port of `mladversarialobjectdetection_tpu/inference/detector.py`: raw RGB
frames in, padded person detections out. Host preprocessing (or, with
`device_preprocess`, `preprocess_device` on the card), the EfficientDet
forward (whose fuseable backbone blocks run the fused MBConv kernels) and
the post mode `global`, `per_class`, `combined` or `tflite` (whose NMS is
the CUDA kernel); `serve_streams` batches several frame sources,
`serve_pipelined` overlaps the host side of the next batch with the card;
`infer` lists one frame's person detections and `__call__` draws them
(`demo/draw.py`, cv2 on the host).

`config.mixed_precision` (`params={"mixed_precision": True}`) serves in
bf16, as the JAX `Detector` does through `EfficientDetNet`: bf16 activations
and the fused blocks' bf16 kernels, float32 predictions, so postprocessing
and NMS see float32. `ckpt_path` loads a pytree file of Flax variables
(`ckpt/io.load_pytree`: either package's `<path>.pkl` or an orbax
directory) or a reference TF1 checkpoint (a prefix, a directory or the
release tarball), converted on the fly with EMA shadows preferred
(`ckpt/convert_tf.py`, read without TensorFlow). `packed_entry` computes
the backbone's first blocks in the space-to-depth layout
(`models/efficientnet_packed.py`).

`mesh` (a `parallel` mesh over the ranks of a process group) serves data
parallel, as JAX's `Detector(mesh=)` (detector.py:35-94, 124-151): the
weights come from rank 0, every rank passes the whole batch to `serve` (or
`serve_pipelined`), the batch is padded to a multiple of the data size by
repeating its last frame, each rank preprocesses and serves its rows (on
the host or the device path), and the detections are gathered, the padding
stripped, so every rank returns the whole batch's. A ('data', 'spatial')
mesh (`make_serve_mesh(n, s)`) also splits each image's rows over the
'spatial' axis, as JAX's (detector.py:84-92, 300-309): the model's input
height must divide by s (JAX's error), each rank preprocesses its data
rows' whole frames (on the host or the device) and keeps its rows of them,
the forward runs row-sharded under the mesh (`parallel/spatial.py`), with
`packed_entry` too, and ends with every anchor's outputs on each rank, and
the detections are gathered over the data axes only. `quantize_int8` under
such a mesh calibrates on whole frames on every rank (as JAX's on its
unsharded host batches), so every rank holds one process's scales, and the
int8 convs then run on each rank's rows and their halo.

`quantize_int8` switches `serve`, `serve_raw`, `infer`, `serve_streams` and
`serve_pipelined` to the W8A8 forward (`inference/quantize.Int8Serve`: the
int8 conv kernel on the card, every block unfused); `load_flax_variables`
switches back to the float forward, as JAX's `variables` setter does.
`export` writes the float serve program (`_serve_float_impl`, whatever
`quantize_int8` did) as a `torch.export` program (`fmt="exported_program"`,
the port's counterpart of JAX's `"stablehlo"`), which
`inference/drivers.ExportedProgramDriver` re-serves; the NMS and fused
MBConv kernels are custom ops inside it (`ops/library.py`). A SavedModel or
TFLite file cannot be written from the port (`inference/export.py`).
"""
from __future__ import annotations

import contextlib
from typing import List, Mapping, Tuple

import numpy as np
import torch

from .. import config as config_lib
from .. import parallel
from ..ckpt import bridge, convert_tf
from ..ckpt import io as ckpt_io
from ..models.efficientdet import EfficientDetNet, spec_from_config
from ..models.init import init_weights
from ..ops import postprocess
from ..ops.preprocess import preprocess_device, preprocess_host
from ..parallel import spatial
from ..utils.device import resolve_device
from ..utils.log import get_logger

logger = get_logger(__name__)

POST_MODES = ("global", "per_class", "combined", "tflite")


def _numpy(det: postprocess.Detections) -> postprocess.Detections:
    return postprocess.Detections(*(t.cpu().numpy() for t in det))


def _row(det: postprocess.Detections, i: int) -> postprocess.Detections:
    return postprocess.Detections(*(a[i] for a in det))


class _ServeProgram(torch.nn.Module):
    """What `Detector.export` traces: preprocessed (images [B, H, W, 3]
    float32, scales [B]) -> the five Detections fields of the float serve
    (`Detector._serve_float_impl`), or with `pre_nms` the three outputs of
    `postprocess.tflite_pre_nms` (JAX's int8 export function,
    detector.py:246-251)."""

    def __init__(self, det: "Detector", pre_nms: bool):
        super().__init__()
        self.net = det.net  # a submodule: its weights go into the program
        self.det = det
        self.pre_nms = pre_nms

    def forward(self, images: torch.Tensor, scales: torch.Tensor) -> tuple:
        if self.pre_nms:
            return tuple(postprocess.tflite_pre_nms(self.det._params_dict,
                                                    *self.net(images)))
        return tuple(self.det._serve_float_impl(images, scales))


class Detector:
    """Inference with the EfficientDet person detector."""

    def __init__(self, model_name: str = "efficientdet-lite4", *,
                 params=None, seed: int = 0, device=None,
                 post_mode: str = "global", ckpt_path: str | None = None,
                 mesh=None, packed_entry: int = 0):
        """
        Args:
          model_name: efficientdet variant.
          params: config override dict (e.g. {'nms_configs': {...}}).
          seed: seed of the random initial weights (`models/init.py`); load
            trained weights with `ckpt_path` or `load_flax_variables`.
          device: "cuda" (the default) or "cpu".
          post_mode: "global", "per_class", "combined" or "tflite"
            (normalized boxes, 0-based classes, no scale-back).
          ckpt_path: the detector's Flax variables: a pytree file
            (`<ckpt_path>.pkl`) or an orbax directory, or a reference TF1
            checkpoint (prefix, directory or `.tgz` / `.tar.gz` / `.tar`),
            converted on the fly (JAX detector.py:71-83); random weights if
            None.
          packed_entry: > 0 computes the stem and the first `packed_entry`
            backbone blocks in the space-to-depth layout on the same weights
            (JAX detector.py:65-68).
          mesh: a `parallel` mesh: data-parallel serving across its ranks
            (see the module notes).
        """
        if post_mode not in POST_MODES:
            raise ValueError(f"post_mode {post_mode!r}: want one of {POST_MODES}")
        self._spatial = (mesh is not None
                         and mesh.shape.get(parallel.SPATIAL_AXIS, 1) > 1)
        self.mesh = mesh
        self.device = resolve_device(device)
        self.post_mode = post_mode
        self.config = config_lib.get_efficientdet_config(model_name)
        if params:
            self.config.override(params, allow_new_keys=False)
        self.spec = spec_from_config(self.config)
        if self._spatial:
            n_sp = mesh.shape[parallel.SPATIAL_AXIS]
            if self.spec.image_size[0] % n_sp != 0:
                raise ValueError(
                    f"spatial serving needs image height "
                    f"{self.spec.image_size[0]} divisible by the "
                    f"'{parallel.SPATIAL_AXIS}' mesh axis size {n_sp}")
        self.net = EfficientDetNet(self.spec, packed_entry=packed_entry).eval()
        if not ckpt_path:
            init_weights(self.net, torch.Generator().manual_seed(seed))
        elif tf_prefix := convert_tf.find_tf_checkpoint(ckpt_path):
            # a reference TF1 checkpoint (the downloaded tarball): every leaf
            # converted, EMA shadows preferred (util_keras.py:108-203)
            bridge.load_flax_variables(self.net, convert_tf.convert_tf_weights(
                convert_tf.load_tf_checkpoint(tf_prefix), self.config, self.spec,
                bridge.torch_to_flax(self.net)))
        else:
            bridge.load_flax_variables(self.net, ckpt_io.load_pytree(ckpt_path))
        self.net.to(self.device)
        if mesh is not None:
            parallel.replicate(mesh, self.net)
        self._params_dict = self.config.as_dict()
        self._int8 = None  # the Int8Serve of quantize_int8, or None: float

    def load_flax_variables(self, variables: Mapping) -> None:
        """Load the JAX package's Flax `{'params', 'batch_stats'}` variables;
        the serve returns to the float forward (detector.py:110-119)."""
        self.net.cpu()
        bridge.load_flax_variables(self.net, variables)
        self.net.to(self.device)
        self._int8 = None

    def _forward(self, images: torch.Tensor):
        return self.net(images) if self._int8 is None else self._int8(images)

    def _post_detections(self, outs, scales) -> postprocess.Detections:
        cls_out, box_out = outs
        if self.post_mode == "tflite":  # normalized boxes, no scale-back
            return postprocess.postprocess_tflite(self._params_dict, cls_out,
                                                  box_out)
        post = {"global": postprocess.postprocess_global,
                "per_class": postprocess.postprocess_per_class,
                "combined": postprocess.postprocess_combined}[self.post_mode]
        return post(self._params_dict, cls_out, box_out, image_scales=scales)

    def _in_mesh(self):
        """The spatial mesh made active (the forward's collectives), or
        nothing."""
        return parallel.use_mesh(self.mesh) if self._spatial else contextlib.nullcontext()

    def _own_rows(self, images: torch.Tensor) -> torch.Tensor:
        """Whole preprocessed images -> this rank's rows of them under a
        spatial mesh (the images themselves otherwise)."""
        with self._in_mesh():
            return spatial.local_rows(images, dim=1)

    @torch.no_grad()
    def serve_tensors(self, images: torch.Tensor, scales: torch.Tensor
                      ) -> postprocess.Detections:
        """Preprocessed [B, H, W, 3] images (under a spatial mesh, this
        rank's rows of them) and scales -> Detections on device, on the int8
        forward after `quantize_int8`."""
        with self._in_mesh():
            return self._post_detections(self._forward(images), scales)

    def _serve_float_impl(self, images: torch.Tensor, scales: torch.Tensor
                          ) -> postprocess.Detections:
        """The serve on the float forward, whatever `quantize_int8` did: the
        program `export` traces (without autograd)."""
        return self._post_detections(self.net(images), scales)

    @torch.no_grad()
    def serve_raw(self, raw: torch.Tensor) -> postprocess.Detections:
        """[B, H, W, 3] uint8 frames of one shape, on the device ->
        Detections on the device, the preprocessing on the device too."""
        images, scales = preprocess_device(raw, self.config.image_size,
                                           self.config.mean_rgb,
                                           self.config.stddev_rgb)
        return self.serve_tensors(self._own_rows(images), scales)

    def preprocess(self, raw_frames) -> Tuple[np.ndarray, np.ndarray]:
        """Host preprocessing of raw frames: (images [B, H, W, 3], scales [B])."""
        imgs, scales = zip(*[
            preprocess_host(np.asarray(f), self.config.image_size,
                            self.config.mean_rgb, self.config.stddev_rgb)
            for f in raw_frames])
        return np.stack(imgs), np.asarray(scales, np.float32)

    def _rows(self, frames: list) -> list:
        """This rank's frames of a batch under the mesh: the batch padded to
        a multiple of the data size with its last frame, then this rank's
        share (JAX detector.py:124-151); the batch itself without a mesh."""
        if self.mesh is None:
            return frames
        axes = parallel.data_axis_names(self.mesh)
        n = self.mesh.axis_size(axes)
        frames = frames + [frames[-1]] * ((-len(frames)) % n)
        rows = len(frames) // n
        i = self.mesh.axis_index(axes)
        return frames[i * rows:(i + 1) * rows]

    def _gather(self, det: postprocess.Detections, b: int
                ) -> postprocess.Detections:
        """Every rank's served rows, gathered in order with the padding
        stripped, as numpy (`det` itself without a mesh)."""
        if self.mesh is not None:
            with parallel.use_mesh(self.mesh):
                det = postprocess.Detections(
                    *(parallel.all_gather_rows(t) for t in det))
        return postprocess.Detections(*(a[:b] for a in _numpy(det)))

    def serve(self, raw_frames, *, device_preprocess: bool = False
              ) -> postprocess.Detections:
        """Batch of raw RGB frames -> padded Detections (numpy) in original coords.

        device_preprocess=True ships the raw uint8 frames, which must share
        one shape, and resizes, normalizes and pads them on the device."""
        frames = [np.asarray(f) for f in raw_frames]
        mine = self._rows(frames)
        if device_preprocess:
            raw = np.stack(mine)
            if raw.dtype != np.uint8:
                raise ValueError("device_preprocess expects uint8 frames")
            return self._gather(
                self.serve_raw(torch.from_numpy(raw).to(self.device)), len(frames))
        images, scales = self.preprocess(mine)
        return self._gather(
            self.serve_tensors(self._own_rows(torch.from_numpy(images)).to(self.device),
                               torch.from_numpy(scales).to(self.device)),
            len(frames))

    def infer(self, frame: np.ndarray, max_boxes: int = 200
              ) -> Tuple[List[tuple], List[float]]:
        """Person detections for one raw frame (detector.py:339-352)."""
        det = self.serve(np.asarray(frame)[None])
        boxes, scores, classes, valid = (det.boxes[0], det.scores[0],
                                         det.classes[0], det.valid[0])
        bb, sc = [], []
        for i in range(boxes.shape[0]):
            if len(bb) == max_boxes:
                break
            if valid[i] and classes[i] == 1:  # person after CLASS_OFFSET
                bb.append(tuple(boxes[i].tolist()))
                sc.append(float(scores[i]))
        return bb, sc

    def __call__(self, frame: np.ndarray) -> np.ndarray:
        """Draw person detections over the frame (detector.py:62-72); the
        drawing (cv2) on the host."""
        from ..demo import draw
        bb, sc = self.infer(frame)
        thresh = self.config.nms_configs.score_thresh or 0.0
        bb, sc = draw.filter_by_thresh(bb, sc, thresh)
        return draw.draw_boxes(frame, bb, sc)

    def serve_streams(self, streams):
        """Serve several frame sources through one batched call per tick
        (detector.py:362-386). The batch is pinned to len(streams): a source
        that has ended is padded with the first frame served and its result
        dropped. Yields per tick a list of per-source Detections (numpy,
        leading dim stripped), None for the sources that have ended."""
        from .streaming import MultiStream
        n = len(streams)
        pad = None
        for indices, frames in MultiStream(streams).play():
            pad = frames[0] if pad is None else pad
            batch = [pad] * n
            for i, f in zip(indices, frames):
                batch[i] = f
            det = self.serve(batch)  # host preprocess: mixed sizes are fine
            out = [None] * n
            for i in indices:
                out[i] = _row(det, i)
            yield out

    def serve_pipelined(self, frames_iter, *, batch_size: int = 1,
                        device_preprocess: bool = False):
        """Serve a frame iterator in batches with host/device overlap
        (detector.py:388-457): a background thread (`data/pipeline.prefetch`)
        preprocesses and uploads batch t+1 while the device runs batch t. The
        last partial batch is padded with its last frame to `batch_size` and
        the padding's results dropped. Yields one Detections per frame, in
        order. device_preprocess=True uploads raw uint8 frames of one shape
        and preprocesses them on the device. Under a mesh each rank serves
        its rows of every batch and yields the whole batch's results."""
        from ..data.pipeline import prefetch

        end = object()  # a None from the caller's iterator is an error

        def host_batches():
            buf, pad_count = [], 0
            it = iter(frames_iter)
            while True:
                frame = next(it, end)
                if frame is end:
                    if not buf:
                        return
                    pad_count = batch_size - len(buf)
                    buf.extend([buf[-1]] * pad_count)
                else:
                    if frame is None:
                        raise ValueError("frames_iter yielded None mid-stream")
                    buf.append(np.asarray(frame))
                if len(buf) == batch_size:
                    mine = self._rows(buf)
                    if device_preprocess:
                        yield np.stack(mine), None, batch_size - pad_count
                    else:
                        images, scales = self.preprocess(mine)
                        yield images, scales, batch_size - pad_count
                    if pad_count:
                        return
                    buf = []

        def put(item):
            images, scales, n = item
            images = torch.from_numpy(images)
            return (images.to(self.device) if scales is None
                    else self._own_rows(images).to(self.device),
                    None if scales is None
                    else torch.from_numpy(scales).to(self.device), n)

        for images, scales, n in prefetch(host_batches(), device_put_fn=put):
            det = self._gather(self.serve_raw(images) if device_preprocess
                               else self.serve_tensors(images, scales),
                               batch_size)
            for i in range(n):
                yield _row(det, i)

    def quantize_int8(self, representative_frames, *, skip_patterns=None) -> None:
        """Switch this detector's serve path to int8 (detector.py:153-188).

        Post-training quantization: conv weights per output channel, the
        activations per tensor with scales calibrated on
        `representative_frames` (raw HxWx3 frames, preprocessed on the host
        in batches of 8 as serve() inputs). Head `predict` layers,
        BatchNorm, activations and postprocessing stay float
        (`inference/quantize.py`). Affects serve, serve_raw, infer,
        serve_streams and serve_pipelined; export() stays float. Under a
        mesh every rank calibrates on all the frames, whole, outside the
        mesh: each holds the scales one process computes."""
        from .quantize import DEFAULT_SKIP, Int8Serve

        frames = list(representative_frames)
        if not frames:
            raise ValueError("quantize_int8 needs representative frames")
        batches = [self.preprocess(frames[i:i + 8])[0] for i in range(0, len(frames), 8)]
        with parallel.use_mesh(None):  # whole frames, whatever mesh is active
            self._int8 = Int8Serve(self.net, batches,
                                   skip_patterns=skip_patterns or DEFAULT_SKIP)

    def export(self, out_path: str, fmt: str = "exported_program", batch_size: int = 1,
               quantize: str | None = None, representative_frames=None) -> None:
        """Export the float serve program (forward + postprocess, fixed shapes)
        (detector.py:216-294).

        fmt: "exported_program" (`torch.export`, a `.pt2` with the weights
        inside; the NMS and fused MBConv kernels as custom ops), which
        `inference.drivers.ExportedProgramDriver` re-serves: preprocessed
        (images [B, H, W, 3] float32, scales [B]) in, the five Detections
        fields out. "stablehlo" is JAX's format and raises ValueError;
        "saved_model" and "tflite" raise NotImplementedError
        (`inference/export.py`). `quantize="int8"` exports, as JAX's, the
        float network up to the TFLite NMS op's inputs
        (`postprocess.tflite_pre_nms`); `representative_frames` is the TFLite
        calibration set and unused here."""
        from . import export as export_lib

        if fmt == "stablehlo":
            raise ValueError("fmt 'stablehlo' is the JAX package's; the port's "
                             "counterpart is fmt='exported_program' (torch.export)")
        if fmt in ("saved_model", "tflite"):
            raise NotImplementedError(export_lib.TF_NOT_PORTED)
        if fmt != "exported_program":
            raise ValueError(f"unknown export format {fmt}")
        example = (torch.zeros((batch_size, *self.spec.image_size, 3), device=self.device),
                   torch.ones((batch_size,), device=self.device))
        export_lib.export_program(_ServeProgram(self, quantize == "int8"), example,
                                  out_path)
