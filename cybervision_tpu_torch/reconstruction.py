"""Pipeline orchestrator (counterpart of cybervision_tpu/reconstruction.py):
images -> ORB features -> matching -> affine RANSAC -> dense correlation
-> depth map or mesh, with the reference's per-phase wall-clock prints.

Both projections are ported. Parallel projection
(Reconstruction._run_affine): the PNG depth-map fast lane, the fused PLY
lane, the word lane (--max-points, OBJ, texture coordinates, grid_mesh
off) and the generic lane above 4096 px. Perspective projection
(Reconstruction._run_perspective): all-pairs matching, multi-pair
7-point RANSAC with top-K LM, incremental pose recovery, dense
correlation of every linked pair pipelined one deep, per-image track
merge, and the final DLT / outlier filter / bundle adjustment.

Device: `--mode=gpu` (the default) and `gpu-low-power` run on CUDA and
fail when no CUDA device is present; `--mode=cpu` runs on the CPU with
each kernel's plain PyTorch version. A run reads parallel.pipeline_mesh()
once: with a mesh (several cards, or parallel.use_mesh) matching,
RANSAC (per pair), P3P candidate scoring and every pyramid level of the
dense correlation (resize to cross-check) shard over it, and everything
else runs on its lead device; without one the single-device path is
unchanged.
"""

from __future__ import annotations

import dataclasses
import sys
import threading

import numpy as np
import torch

from cybervision_tpu_torch import native
from cybervision_tpu_torch.config import (
    HardwareMode,
    InterpolationMode,
    MeshMode,
    ProjectionMode,
    ReconstructionConfig,
)
from cybervision_tpu_torch.errors import ImageError, TriangulationError
from cybervision_tpu_torch.images import SourceImage, read_metadata
from cybervision_tpu_torch.ops import correlation, epipolar, matching, sfm
from cybervision_tpu_torch.ops.affine_triangulation import (
    triangulate_affine,
    triangulate_affine_word,
    triangulate_affine_word_sampled,
)
from cybervision_tpu_torch.ops.features import extract_keypoints_pyramid_packed
from cybervision_tpu_torch.output.writers import (
    TextureEncoder,
    output_surface,
    write_depth_image_affine_device,
)
from cybervision_tpu_torch.parallel import AUTO, resolve_mesh
from cybervision_tpu_torch.utils.progress import DetailTimer, PhaseTimer, ProgressBar


def select_device(hardware: HardwareMode) -> torch.device:
    """--mode -> torch device. GPU modes never fall back to the CPU."""
    if hardware == HardwareMode.CPU:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"--mode={hardware.value} needs a CUDA device and none is"
            " available (pass --mode=cpu to run on the CPU)"
        )
    return torch.device("cuda")


class Reconstruction:
    """One reconstruction run. `images` optionally supplies the
    SourceImages in memory (then `filenames` only labels them)."""

    def __init__(
        self,
        filenames: list[str],
        out_filename: str,
        cfg: ReconstructionConfig,
        quiet: bool = False,
        images: list[SourceImage] | None = None,
    ):
        if len(filenames) < 2:
            raise ImageError("need at least 2 source images")
        if images is not None and len(images) != len(filenames):
            raise ImageError("images and filenames differ in length")
        self.filenames = filenames
        self.out_filename = out_filename
        self.cfg = _apply_hardware_mode(cfg)
        self.quiet = quiet
        self.device = select_device(self.cfg.hardware)
        self.mesh = resolve_mesh(AUTO, self.device)
        if self.mesh is not None:
            self.device = self.mesh.lead
        self.images: dict[int, SourceImage] = dict(enumerate(images or []))
        # Degradation counters (log-and-continue, reconstruction.rs:
        # 267-274): pairs that fell out of the graph and why.
        self.ransac_failures = 0
        self.dense_failures = 0
        self.surface = None
        # Phase phrase -> seconds of this run (the reference's per-phase
        # wall-clock prints, reconstruction.rs:316-318, as data).
        self.phases: dict[str, float] = {}
        self._rgb_prefetch: tuple[threading.Thread, dict] | None = None
        self._texture_encoder: tuple[list[int], TextureEncoder] | None = None

    def _timer(self, phrase: str, quiet: bool) -> PhaseTimer:
        return PhaseTimer(phrase, quiet, self.phases)

    def image(self, i: int) -> SourceImage:
        if i not in self.images:
            with self._timer("Loaded images", True):
                self.images[i] = SourceImage.load(self.filenames[i])
        return self.images[i]

    def _print(self, *args):
        if not self.quiet:
            print(*args)

    # -- sparse phase ---------------------------------------------------
    def match_pair(self, i: int, j: int) -> np.ndarray:
        """Multi-scale ORB + matching (reconstruction.rs:400-500), the
        packed rows staying on the device until the match table."""
        img1, img2 = self.image(i), self.image(j)
        threshold = self.cfg.matching.threshold(self.cfg.projection)
        with self._timer("Extracted feature points", self.quiet):
            packed1, packed2 = extract_keypoints_pyramid_packed(
                [img1.img, img2.img], self.cfg.orb, self.device
            )
        with self._timer("Matched keypoints", self.quiet):
            matches, n1, n2 = matching.match_keypoints_packed(
                packed1, packed2, threshold, mesh=self.mesh
            )
        self._print(f"Image {self.filenames[i]} has {n1} feature points")
        self._print(f"Image {self.filenames[j]} has {n2} feature points")
        self._print(f"Found {len(matches)} matches")
        return matches

    def find_f(self, i: int, j: int, matches: np.ndarray):
        img1, img2 = self.image(i), self.image(j)
        max_dim = float(max(*img1.dimensions, *img2.dimensions))
        pb = ProgressBar(show_message=True) if not self.quiet else None
        with self._timer("Completed RANSAC fitting", self.quiet):
            result = epipolar.find_fundamental_matrix(
                matches, self.cfg.projection, max_dim, self.cfg.ransac, pb,
                device=self.device, mesh=self.mesh,
            )
        if pb:
            pb.finish()
        self._print(f"Kept {len(result.inliers)} matches")
        return result

    def _sparse_matches(self, i: int, j: int) -> np.ndarray:
        """Per-pair header prints + feature matching (the sparse half of
        reconstruct_sparse, shared with the multi-pair RANSAC)."""
        img1, img2 = self.image(i), self.image(j)
        self._print(f"Processing images {self.filenames[i]} and {self.filenames[j]}")
        self._print(
            f"Image {self.filenames[i]} has scale width {img1.scale[0]!r},"
            f" height {img1.scale[1]!r}"
        )
        if img1.tilt_angle is not None and img2.tilt_angle is not None:
            self._print(f"Relative tilt angle is {img2.tilt_angle - img1.tilt_angle}")
        return self.match_pair(i, j)

    def reconstruct_sparse(self, i: int, j: int):
        matches = self._sparse_matches(i, j)
        try:
            return self.find_f(i, j, matches).f
        except ValueError as err:
            print(f"Failed to complete RANSAC task: {err}", file=sys.stderr)
            self.ransac_failures += 1
            return None

    # -- dense phase ----------------------------------------------------
    def correlate_pair(self, i: int, j: int, f: np.ndarray, device_out):
        self._print(
            f"Performing dense correlation of images {self.filenames[i]}"
            f" and {self.filenames[j]}"
        )
        if self.mesh is not None:
            name = self.mesh.describe()
        elif self.device.type == "cpu":
            name = "CPU"
        else:
            name = torch.cuda.get_device_name(self.device)
        if self.cfg.hardware == HardwareMode.GPU_LOW_POWER:
            name += " low-power"
        self._print(f"Selected hardware: {name}")
        pb = ProgressBar() if not self.quiet else None
        with self._timer("Completed dense correlation", self.quiet):
            out = correlation.correlate_images(
                self.image(i), self.image(j), f, self.cfg.projection,
                self.cfg.correlation, pb, device_out=device_out,
                device=self.device, mesh=self.mesh,
            )
        if pb:
            pb.finish()
        return out

    # -- full pipeline ----------------------------------------------------
    def run(self) -> None:
        with self._timer("Completed reconstruction", self.quiet):
            if self.cfg.projection == ProjectionMode.AFFINE:
                self._run_affine()
            else:
                self._run_perspective()

    def _out_scale(self) -> tuple[float, float, float]:
        """Depth scale for the writers (reconstruction.rs:223-233): xy
        fixed at 1.0, affine z folded by (x+y)/2 for formula parity."""
        s = (1.0, 1.0, float(self.cfg.scale))
        if self.cfg.projection == ProjectionMode.AFFINE:
            return (s[0], s[1], s[2] * (s[0] + s[1]) / 2.0)
        return s

    def _run_affine(self) -> None:
        """Reconstruction._run_affine of the JAX package, lane for lane:
        - the PNG fast lane (interpolation none, image output): the
          (H, W, 3) planes stay on the device for the depth colouring;
        - the fused PLY lane (_affine_ply_lane): the delta plane, the
          native writer streaming the grid mesh;
        - the word lane (images up to 4096 px): the compact word grid,
          subsampled on the device under --max-points and otherwise
          fetched whole, then triangulate_affine_word(_sampled);
        - the generic lane (larger images): the host planes, the
          --max-points subsample by RandomState.choice.
        The word and generic lanes write through output_surface."""
        if len(self.filenames) > 2:
            print(
                "Triangulation of multiple affine images is not supported;"
                " using the first pair",
                file=sys.stderr,
            )
        f = self.reconstruct_sparse(0, 1)
        if f is None:
            raise TriangulationError("No matching image pairs found")

        lower = self.out_filename.lower()
        fast_lane = self.cfg.interpolation == InterpolationMode.NONE and not lower.endswith(
            (".ply", ".obj")
        )
        ply_lane = self._affine_ply_lane(lower)
        img1, img2 = self.image(0), self.image(1)
        word_lane = (
            not fast_lane
            and not ply_lane
            and max(*img1.dimensions, *img2.dimensions) <= 4096
        )
        if not fast_lane:
            self._prefetch_rgb([0, 1])
        correlated = self.correlate_pair(
            0, 1, f,
            device_out="delta" if ply_lane else ("word" if word_lane else fast_lane),
        )

        if fast_lane:
            with self._timer("Saved result", self.quiet):
                write_depth_image_affine_device(
                    self.out_filename, correlated,
                    float(np.sign(self._out_scale()[2])),
                )
            return

        word = None
        sampled_dev = None
        if ply_lane:
            word = self._write_ply(*correlated)
            if word is None:
                return
        elif word_lane:
            if self.cfg.max_points is not None:
                sampled_dev = correlated
            else:
                with self._timer("Fetched correlation grid", True):
                    word = correlated.cpu().numpy()

        with self._timer("Completed triangulation post-processing", self.quiet):
            if sampled_dev is not None:
                h, w = sampled_dev.shape
                idx, words = correlation.sample_word_grid(
                    sampled_dev, min(self.cfg.max_points, h * w), self.cfg.ransac.seed
                )
                surface = triangulate_affine_word_sampled(idx, words, h, w)
            elif word is not None:
                surface = triangulate_affine_word(
                    word, self.cfg.max_points, self.cfg.ransac.seed
                )
            else:
                surface = triangulate_affine(correlated)
                if (
                    self.cfg.max_points is not None
                    and surface.n_points > self.cfg.max_points
                ):
                    keep = np.random.RandomState(self.cfg.ransac.seed).choice(
                        surface.n_points, self.cfg.max_points, replace=False
                    )
                    surface.points3d = surface.points3d[keep]
                    surface.tracks = surface.tracks[keep]
                    # No longer a dense grid: meshing takes the generic
                    # Delaunay.
                    surface.grid_shape = None

        self._write_output(surface, [0, 1])

    def _write_ply(self, d16_dev: torch.Tensor, word_dev: torch.Tensor):
        """The fused PLY lane's tail: fetch the delta plane (the exact
        word plane instead when bit 15 flags an out-of-range delta) while
        a thread prepares the vertex colours, then stream the mesh with
        the native writer. With no correlated pixel (or a colour plane of
        another shape) nothing is written and the word grid is returned
        for the generic path's semantics; else None."""
        rgb_box: list = [None]
        rgb_thread = None
        if self.cfg.mesh == MeshMode.VERTEX_COLORS:

            def _prep_rgb():
                rgb_box[0] = self._take_rgb([0])[0]

            rgb_thread = threading.Thread(target=_prep_rgb)
            rgb_thread.start()
        word = None
        with self._timer("Fetched correlation grid", True):
            d16 = d16_dev.cpu().numpy().astype(np.uint16)
            if d16[0, 0] & 0x8000:
                word = word_dev.cpu().numpy()
        if rgb_thread is not None:
            rgb_thread.join()
        rgb = rgb_box[0]
        if not (d16 & 0x4000).any() or (rgb is not None and rgb.shape[:2] != d16.shape):
            return word if word is not None else correlation.unpack_delta_grid(d16)
        with self._timer("Saved result", self.quiet):
            if word is not None:
                native.ply_write_corr_grid(self.out_filename, word, self._out_scale(), rgb)
            else:
                native.ply_write_delta_grid(self.out_filename, d16, self._out_scale(), rgb)
        return None

    def _affine_ply_lane(self, lower: str) -> bool:
        """The fused PLY lane applies when the generic path would take the
        native grid-mesh shortcut anyway, the grid fits the 12-bit
        compact packing, and the native library builds."""
        if not (
            lower.endswith(".ply")
            and self.cfg.interpolation == InterpolationMode.DELAUNAY
            and self.cfg.mesh in (MeshMode.PLAIN, MeshMode.VERTEX_COLORS)
            and self.cfg.max_points is None
            and self.cfg.output.grid_mesh
        ):
            return False
        img1, img2 = self.image(0), self.image(1)
        if max(*img1.dimensions, *img2.dimensions) > 4096:
            return False
        return native.available()

    def _run_perspective(self) -> None:
        """Reconstruction._run_perspective of the JAX package
        (reconstruction.rs:198-321): all-pairs matching, one multi-pair
        RANSAC (per-pair find_f under a mesh), pose recovery, the dense
        correlation of every linked pair pipelined one deep (each pair's
        word grid is fetched and its tracks extended while the next pair
        runs on the device), a track merge per image, then the final DLT,
        outlier filter and bundle adjustment. Failed pairs log and
        continue, counted in ransac_failures / dense_failures."""
        n = len(self.filenames)
        pipeline = sfm.SfmPipeline(
            [self.image(i) for i in range(n)], self.cfg, quiet=self.quiet,
            device=self.device, phases=self.phases, mesh=self.mesh,
        )
        pair_list: list[tuple[int, int, np.ndarray]] = []
        for i in range(n - 1):
            for j in range(i + 1, n):
                try:
                    matches = self._sparse_matches(i, j)
                except Exception as err:
                    print(
                        f"Failed to match images {self.filenames[i]} and"
                        f" {self.filenames[j]} ({err})",
                        file=sys.stderr,
                    )
                    continue
                pair_list.append((i, j, matches))

        if self.mesh is not None:
            for i, j, matches in pair_list:
                try:
                    result = self.find_f(i, j, matches)
                except ValueError as err:
                    print(f"Failed to complete RANSAC task: {err}", file=sys.stderr)
                    self.ransac_failures += 1
                    continue
                pipeline.add_sparse_pair(i, j, result.f, result.inliers)
        elif pair_list:
            pb = ProgressBar(show_message=True) if not self.quiet else None
            with self._timer("Completed RANSAC fitting", self.quiet):
                max_dims = [
                    float(max(*self.image(i).dimensions, *self.image(j).dimensions))
                    for i, j, _ in pair_list
                ]
                multi = epipolar.find_fundamental_matrix_multi(
                    [m for _, _, m in pair_list], self.cfg.projection, max_dims,
                    self.cfg.ransac, pb, device=self.device,
                )
            if pb:
                pb.finish()
            for (i, j, _), result in zip(pair_list, multi):
                if isinstance(result, Exception):
                    print(f"Failed to complete RANSAC task: {result}", file=sys.stderr)
                    self.ransac_failures += 1
                    continue
                self._print(f"Kept {len(result.inliers)} matches")
                pipeline.add_sparse_pair(i, j, result.f, result.inliers)

        with self._timer("Recovered camera poses", True):
            linked = pipeline.recover_camera_poses()
        if not linked:
            raise TriangulationError("No matching image pairs found")
        self._prefetch_rgb(sorted(linked))

        pending: tuple[int, int, torch.Tensor] | None = None

        def flush_pending() -> None:
            nonlocal pending
            if pending is None:
                return
            pi, pj, dev = pending
            pending = None
            try:
                with self._timer("Fetched correlation grid", True):
                    grid = correlation.unpack_correlated(dev.cpu().numpy())
            except Exception as err:
                print(f"Failed to perform dense correlation of images: {err}", file=sys.stderr)
                self.dense_failures += 1
                return
            with self._timer("Added dense image pair", self.quiet):
                pipeline.add_dense_pair(pi, pj, grid)

        for i in range(n - 1):
            if i not in linked:
                continue
            for j in range(i + 1, n):
                if j not in linked:
                    continue
                f = pipeline.pair_f(i, j)
                if f is None:
                    continue
                img_i, img_j = self.image(i), self.image(j)
                compact = max(*img_i.dimensions, *img_j.dimensions) <= 4096
                try:
                    correlated = self.correlate_pair(
                        i, j, f, device_out="word" if compact else True
                    )
                except Exception as err:  # log-and-continue (reconstruction.rs:719-723)
                    print(f"Failed to perform dense correlation of images: {err}", file=sys.stderr)
                    self.dense_failures += 1
                    continue
                flush_pending()
                pending = (i, j, correlated)
            # Tracks for image i must include every (i, *) pair before
            # the merge; drain the pipeline.
            flush_pending()
            with self._timer(f"Merged tracks for {self.filenames[i]}", self.quiet):
                pipeline.merge_tracks(i)

        with self._timer("Completed triangulation post-processing", self.quiet):
            surface = pipeline.complete(
                max_points=self.cfg.max_points,
                bundle_adjustment=self.cfg.bundle_adjustment,
            )
        # The surface's cameras and tracks are remapped onto
        # sorted(linked); depth maps project to the first RECOVERED
        # image (reconstruction.rs:768). Kept for callers that check the
        # geometry.
        self.surface = surface
        linked_sorted = sorted(linked)
        self._write_output(surface, linked_sorted, linked_sorted.index(linked[0]))

    def _prefetch_rgb(self, linked_images: list[int]) -> None:
        """Load the output-phase colour planes on a thread while the
        device works. For a texture-coordinates OBJ the thread then
        starts the texture encode (to memory), which hides behind the
        dense phase; a file-backed PNG source with no databar crop is
        marked for a verbatim copy instead."""
        results: dict[int, np.ndarray] = {}
        textured_obj = (
            self.cfg.mesh == MeshMode.TEXTURE_COORDINATES
            and self.out_filename.lower().endswith(".obj")
        )

        def work():
            for i in linked_images:
                results[i] = self.image(i).load_rgb_plane()
            if textured_obj:
                sources = []
                for i in linked_images:
                    src = self.image(i).filename
                    copy = (
                        src.lower().endswith(".png")
                        and read_metadata(src).databar_height == 0
                    )
                    sources.append(src if copy else None)
                self._texture_encoder = (
                    list(linked_images),
                    TextureEncoder([results[i] for i in linked_images], sources),
                )

        t = threading.Thread(target=work, daemon=True)
        t.start()
        self._rgb_prefetch = (t, results)

    def _take_rgb(self, linked_images: list[int]) -> list[np.ndarray]:
        pre = self._rgb_prefetch
        if pre is not None:
            t, results = pre
            t.join()
            self._rgb_prefetch = None
            if all(i in results for i in linked_images):
                return [results[i] for i in linked_images]
        return [self.image(i).load_rgb_plane() for i in linked_images]

    def _write_output(
        self, surface, linked_images: list[int], project_to: int = 0
    ) -> None:
        with self._timer("Saved result", self.quiet):
            with DetailTimer("take_rgb"):
                images_rgb = self._take_rgb(linked_images)
            pre = self._texture_encoder
            encoder = pre[1] if pre is not None and pre[0] == list(linked_images) else None
            self._texture_encoder = None
            output_surface(
                surface,
                self._out_scale(),
                project_to,
                images_rgb,
                self.out_filename,
                self.cfg.interpolation,
                self.cfg.mesh,
                output_cfg=self.cfg.output,
                texture_encoder=encoder,
            )


def _apply_hardware_mode(cfg: ReconstructionConfig) -> ReconstructionConfig:
    """gpu-low-power clamps the sweep window like the reference's reduced
    corridor segments (gpu/mod.rs:31-35)."""
    if cfg.hardware == HardwareMode.GPU_LOW_POWER:
        clamp = cfg.correlation.corridor_window_low_memory
        corr = dataclasses.replace(
            cfg.correlation,
            corridor_window_fixed=min(
                cfg.correlation.corridor_window_fixed or clamp, clamp
            ),
        )
        return dataclasses.replace(cfg, correlation=corr)
    return cfg


def reconstruct(
    filenames: list[str],
    out_filename: str,
    cfg: ReconstructionConfig = ReconstructionConfig(),
    quiet: bool = False,
    images: list[SourceImage] | None = None,
) -> dict[str, float]:
    """Run one reconstruction; returns its phase times (phrase -> s)."""
    rec = Reconstruction(filenames, out_filename, cfg, quiet, images)
    rec.run()
    return rec.phases
