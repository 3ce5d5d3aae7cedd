#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cybervision_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each of which raises on failure:

1. Print the card's name and power limit, build the hand-written
   kernels (cybervision_tpu_torch/csrc/*.cu, nvcc for sm_90a), and print
   each kernel's registers, spills and shared memory (ptxas -v).
2. Hold every kernel against its plain PyTorch version on the card, at
   the shapes the 1024x1024 main path gives it, and time both:
     K1 ncc_sweep  — the refine sweep of the finest level in its "horiz"
                     (main path), "vert" and per-pixel forms (the last on
                     a checkerboard of axes in 64-pixel squares);
                     tolerances of tests/test_pallas_ncc.py (under 0.5 %
                     of valid flags differ, corr within 1e-4, over 99.5 %
                     of positions equal), the per-pixel form bit for bit;
                     also all three forms at 999x777 (no multiple of a
                     tile) and at windows 8 and 128 on a 300x280 plane,
                     the per-pixel one with its axis flipping across the
                     diagonal; the per-pixel form prints its tile votes
                     and the tiles that stage one band of the warp or two;
     K2 score      — 50,000 affine candidates against the match table at
                     8192 rows and at the main path's bucket; counts equal,
                     sums within rtol 1e-5; also 50,001 candidates against
                     the bucket with holes in the middle of its mask, and
                     with no row valid;
     K3 gather     — (13, 4, 50,000) draws from the packed table at the
                     same two sizes; exact. torch.index_select is timed
                     beside it as the library yardstick, in turns with
                     the kernel: CUDA events around 200 calls (5 turns,
                     medians), the device time per call from
                     torch.profiler (5 turns of 50 calls in one profile),
                     and the host time per call (perf_counter around
                     1,000 calls with no sync, 5 turns, medians), there
                     also of the same launch through PyTorch's public
                     host API (gather_public_path);
     K1 wide       — all three forms at 1024x1024 and window 192 (in
                     chunks of offsets per stripe), bit-equal to the
                     plain version and timed; the row-halo form at 192
                     over phase 4's mesh, bit-equal to the plain version;
     draws         — the threefry draws of one RANSAC round (utils.prng,
                     (13, 4, 50,000) int32) equal on the card and on the
                     CPU, timed beside torch.randint, the draw they
                     replaced.
3. Run the main path end to end through reconstruction.reconstruct: the
   synthetic 1024x1024 SEM pair, ReconstructionConfig(projection=AFFINE,
   mesh=VERTEX_COLORS), to a PLY in a temporary directory. One warm-up
   run, then three timed runs, each with the kernels' launch counters set
   to 0 just before and read just after. Checks: every kernel launched,
   the PLY holds over 30 % of the pixels as vertices, and its depth tracks
   the planted disparity. Then one more warm run under torch.profiler:
   the card's busy share of the run, the ops by device time, and each
   kernel's device milliseconds in that run. Then RANSAC alone on the
   main path's matches with an early exit no count reaches, so all 20
   rounds run: K2 and K3 launches and device milliseconds per run, and
   its seconds. Phases 1 to 3 run without a mesh: the single-card path.
4. The multi-device path over a mesh: every visible card when there are
   two or more, else four row shards on the one card (the sharded code
   runs for real either way: halo exchange, global row bounds, a launch
   per shard). K1s, ncc_sweep_sharded, at phase 2's 1024x1024 fields in
   its three forms must equal the unsharded K1 exactly and agree with
   its sharded plain version within K1's tolerances (the per-pixel form
   bit for bit); its time includes the halo exchange. Then the main path end to end under the mesh (a
   warm-up and three timed runs, phase 3's gates, the launches per run
   checked against the plan: one K1 per shard on each sharded level,
   one K2 and one K3 per shard per RANSAC round; every pyramid level
   whose rows shard ran row-sharded from resize to cross-check), one
   more run under the profiler for K1s's device milliseconds per run,
   and correlate_images under the mesh for the F of an unsharded run,
   whose delta plane must equal the unsharded one.
5. Affine lanes, on one card, through reconstruction.reconstruct:
   BASELINE #1 — the 1024x1024 pair to a PNG depth map with
   interpolation none (the fast lane): a cold run, best of 3 warm runs,
   one profiled run (busy share); gates read back from the PNG with
   this script's own zlib decoder: over 30 % of the pixels opaque,
   exactly the pixels that phase 3's PLY has as vertices, and the depth
   through the nearest colour-table entry tracks the planted disparity
   (|r| >= 0.9). BASELINE #4 — a 4032x3024 pair to a texture-coordinates
   OBJ with --max-points 500,000 (the word lane, subsampled on the
   card): one warm-up run; then K1 in both static forms at the full-
   resolution level's window at 4032x3024 (bit-equal), K2 and K3 at the
   pair's match table against their plain versions, timed; then best
   of 2 timed runs and one profiled run. Gates: min(500,000, valid
   pixels) vertices, each at a valid pixel with the dense result's
   exact depth (one correlate_images run for the same F), faces, both
   texture PNGs equal to the images, and the depth tracking the planted
   disparity (r >= 0.9).
6. The perspective path, on one card, through
   reconstruction.Reconstruction with the default RANSAC budgets (20
   rounds of 50,000 samples a pair, no early exit): tests/
   perspective_scene.py's renderer, copied (render_perspective), with K
   scaled with the image. BASELINE #3 — 2 views of 320x256 to an OBJ
   (Delaunay, vertex colours, bundle adjustment), the 35 mm focal length
   43 on the in-memory images as the EXIF tag would give it; BASELINE
   #5 — 3 views to a merged PLY with --focal-length 43; the same 3-view
   scene at 1024x820; a diagonal pair at 1024x820 to an OBJ (camera 2
   translated along both image axes at once, K the one 43 mm gives),
   whose epipolar lines cross the image at 38-54 degrees, so that no
   level has a uniform sweep axis and K1 runs its per-pixel form. Each:
   a warm-up run, timed runs (best of 2 for BASELINE #3, one for the
   others) with launches per run (K1's
   per-pixel form apart), grouped phase seconds, peak device memory,
   then one profiled run (busy share, top kernels by device time).
   Gates: no RANSAC or dense
   failure but the 3-view scene's pair of views 2-3 (the JAX package
   proves it unlinkable at the default floor), every view recovered with
   its rotation and translation direction near the renderer's after
   aligning camera 1 (POSE_TOL_DEG; BASELINE #5 at the JAX package's own
   errors on that scene plus POSE_MARGIN_DEG), every point in front of
   the cameras that see it, depth seen from camera 1 tracking the
   renderer's (r >= 0.9), the JAX tests' vertex and face floors, and K1's
   per-pixel form launched in the diagonal run. The DLT's host float64
   eigh and its card eigh + host polish are timed on each run's smallest
   and largest triangulation. Then K1's per-pixel form on the diagonal
   run's finest-level fields, K2 at C = 150,000 candidates of the
   7-point solver and K3 at (13, 7, 50,000) on the 3-view full-width
   run's largest pair table, each against its plain version, timed with
   its bound.
7. The perspective path under phase 4's mesh: BASELINE #5 (P3P
   candidates scored in one block per shard: blocks = shards x sharded
   calls) and the diagonal pair (every K1 launch the per-pixel form,
   n per sharded sweep), each a warm-up, one timed and one profiled run
   with phase 6's gates and the correlation plan; then the diagonal
   pair's correlate_images for the F of phase 6's unsharded run, under
   the mesh and without it, equal bit for bit.
8. The CLI from files (`python -m cybervision_tpu_torch`, cli.main), the
   inputs written by this script's own writers (it needs no Pillow) or
   read from the committed JPEG fixtures:
   (a) phase 3's pair as FEI SEM TIFFs with a 60-row databar of junk and
       tag 34683 (pixel size, stage tilt, databar height) -> PLY: a cold
       subprocess on a copy of the package without its builds (it builds
       the kernels and the native library from the sources; the copy
       must be the package it imported), the same subprocess warm, and
       cli.main best of 3. Every PLY byte-equal to reconstruct's on the
       in-memory arrays with the same scale and tilt; depth tracks the
       planted disparity;
   (b) the same files -> PNG depth map with --mode=gpu-low-power: equal to
       the in-memory GPU_LOW_POWER run's, "low-power" printed, the fixed
       pass's coarse levels swept at the clamp (window 8);
   (c) the EXIF JPEG pair (tests/fixtures/torch_persp_v{0,1}.jpg, no
       --focal-length) -> OBJ: the decoded planes equal Pillow's (the npz
       beside them), K the 43 mm K, the OBJ equal to the in-memory run on
       the decoded planes, phase 6's camera and depth gates;
   (d) BASELINE #4 from 4032x3024 PNG files (png_encode): each texture a
       verbatim copy of its input, the OBJ equal to phase 5's;
   (e) (a)'s files -> .jpg depth map (--interpolation=none): the file is
       the port's JPEG encoder on the RGB of the .png run on the same
       files, decodes within JPEG_PSNR_MIN_DB of it, and the encoder's
       bytes on encoder_cases() have the committed SHA-256 of Pillow's;
       the encode timed at 1024x1024 and 4032x3024;
   (f) phase 6's pair at full width (1024x819) as committed progressive
       JPEGs (tests/fixtures/torch_persp_full_v{0,1}.jpg, EXIF 41989 =
       43, no --focal-length) -> OBJ: the planes have the committed
       SHA-256 of Pillow's and equal the baseline twins', K the 43 mm K,
       the OBJ equal to the in-memory run on the decoded planes, phase
       6's camera and depth gates;
   (g) (a)'s pair rewritten by write_tiff as tiled (256x256), planar and
       BigTIFF files -> PLY, each byte-equal to (a)'s;
   (h) phase 3's pair as 8-bit gray-palette BMPs (write_bmp: what JEOL and
       Hitachi SEMs save) -> PLY, byte-equal to reconstruct's on the
       arrays, with every import of Pillow blocked in the run (as in (i));
   (i) the pair as 32-bit float TIFFs (write_tiff "float": ImageJ's
       32-bit save), JPEG-compressed YCbCr TIFFs (write_tiff "jpeg") and
       RLE8 BMPs (write_bmp) -> .tif, .tif and .bmp depth maps
       (--interpolation=none), each file equal to imageio.rgba_encode on
       the RGBA of the in-memory run on the decoded planes. Every decoded
       plane of (h) and (i) has the committed SHA-256 of Pillow's
       (instrument_files, FORMATS_SHA256);
   (j) with Pillow blocked as well: phase 3's pair as 8-bit gray GIFs
       (write_gif, one interlaced) -> PLY, byte-equal to reconstruct's on
       the arrays; the full-width pair as committed lossy WebPs (ALPH,
       VP8 and EXIF chunks) and BASELINE #3's views as committed lossless
       WebPs (VP8L, EXIF) -> OBJ, no --focal-length, with (f)'s gates;
       every plane has the committed SHA-256 of Pillow's ("gif_webp"),
       every WebP's EXIF focal length is 43;
   (k) with Pillow blocked as well (raster_files): phase 3's pair as
       16-bit binary PGMs (P5, maxval 65535) -> PLY and as little-endian
       SPIDER files -> PNG depth map, each byte-equal to reconstruct's
       on the arrays; BASELINE #3's views as RLE TGAs -> OBJ with
       --focal-length=43 and (f)'s gates; the tinted pair as CMYK TIFFs
       -> PLY, byte-equal to reconstruct's on the decoded planes; every
       plane has the committed SHA-256 of Pillow's ("raster");
   (l) with Pillow blocked as well (codec_files, icon_files): phase 3's
       pair as LZMA TIFFs (write_tiff "lzma", predictor 2) -> PLY and as
       headerless DIBs (write_bmp dib) -> PNG depth map, each byte-equal
       to reconstruct's on the arrays; BASELINE #3's views as the
       committed zstd TIFFs (tests/fixtures/torch_persp_v{0,1}_zstd.tif)
       -> OBJ with --focal-length=43, and as PNGs whose only EXIF is a
       "Raw profile type exif" zTXt chunk after the image data
       (write_png_text_exif) -> OBJ with no --focal-length (the 43 mm K
       from the chunk), both with (f)'s gates; ICO (8-bit with an AND
       mask, 32-bit, PNG), CUR and ICNS (RLE it32 with t8mk, PNG) icons
       decoded only. Every plane has the committed SHA-256 of Pillow's
       ("codecs", "icons"); it fails by name where Python's lzma module
       does not import;
   (m) with Pillow blocked as well (legacy_files): phase 3's pair as
       byte-encoded 8-bit Sun rasters -> PLY, byte-equal to
       reconstruct's on the arrays; BASELINE #3's views as IM "RGB" files
       (line-interleaved planes) -> OBJ with --focal-length=43 and (f)'s
       gates; MSP version 1 and 2, XBM, XPM of 216 and 512 colours, Sun
       rasters of 1, 4 (colour map) and 32 bits, IM "L 32F" and "P" (colour
       Lut) decoded only, each timed; the committed damaged LZMA TIFF
       (tests/fixtures/torch_lzma_damaged.tif, a strip Pillow's libtiff
       reads) decoded, with the liblzma ctypes loaded printed. Every plane
       has the committed SHA-256 of Pillow's ("legacy", "lzma damaged");
   (n) with Pillow blocked as well (jpeg_coding_files): phase 3's pair as
       arithmetic-coded sequential JPEGs (arith_jpeg) -> PLY, byte-equal
       to reconstruct's on the decoded planes, and as 8-bit lossless JPEGs
       (lossless_jpeg) -> PLY, byte-equal to reconstruct's on the arrays
       (the planes are the arrays); BASELINE #3's views as arithmetic
       progressive JPEGs with EXIF 41989 = 43 -> OBJ with no
       --focal-length and (f)'s gates; a block-smoothed arithmetic
       progressive file, a lossless RGB file with restarts and an
       arithmetic file with a DAC segment between scans decoded, each
       timed; a 12-bit and an arithmetic-coded lossless (SOF11) file
       refused without "yet". Every plane has the committed SHA-256 of
       Pillow's ("jpeg codings", read with Pillow's read block raised to
       the whole file, since Pillow fails on arithmetic data past its
       first 64 KiB);
   (o) with Pillow blocked as well (pillow_rest_files): phase 3's pair as
       colour old-style JPEG-in-TIFFs (ojpeg_tiff: 2x2, tables only) ->
       PLY, byte-equal to reconstruct's on the decoded planes, as
       PackBits RGB PSDs -> PNG depth map and as BITPIX 8 FITS files ->
       PLY, each byte-equal to reconstruct's on the arrays; BASELINE #3's
       views as CMYK PSDs -> OBJ with --focal-length=43 and (f)'s gates;
       an interchange-format old-style JPEG-in-TIFF, BITPIX 16 and
       GZIP_1 FITS, DCX, GBR, IM Tools, IPTC (a JPEG), McIdas, PIXAR and
       XV files decoded, each timed. Every plane has the committed
       SHA-256 of Pillow's ("pillow rest");
   (p) with Pillow blocked as well (block_texture_files): phase 3's pair as
       DXT1 DDS files (bc1_file: each block's channel extremes as its
       endpoints) -> PLY and as BC7 DDS files (DX10, bc7_mode6_blocks) ->
       PNG depth map, each byte-equal to reconstruct's on the decoded
       planes; BASELINE #3's views as BLP2 DXT5 files (dxt5_blocks) -> OBJ
       with --focal-length=43 and (f)'s gates; a 4032x3024 BC7 plane,
       seeded random BC6H (unsigned and signed) and BC5S blocks, a BC4, a
       5:6:5, an LA and a palette DDS, BLP1 JPEG and palette files and
       FTEX DXT1 and raw files decoded, each timed. Every plane has the
       committed SHA-256 of Pillow's ("block textures");
   (q) with Pillow blocked as well (fli_pcd_files): phase 3's pair as FLC
       files (a COLOR_256 palette and a BRUN chunk) -> PLY and cropped to
       768x512 as Photo CD files, unrotated and at orientation 1 -> PNG
       depth maps, each byte-equal to reconstruct's on the decoded
       planes; a COLOR_64 FLI and FLCs whose first frame is BLACK then
       LC, SS2 at an odd width or COPY decoded, each timed; every plane
       has the committed SHA-256 of Pillow's ("fli pcd"). (a)'s SEM TIFF
       pair -> .qoi and .ppm depth maps, each rgba_encode's bytes of the
       QOI's RGBA, which writers._save_image then writes as .tga, .sgi,
       .im, .dib and .dds (each timed, each rgba_encode's bytes and read
       back to that RGBA by the port's readers);
   (r) with Pillow blocked as well (cli_jpeg2000): the committed JPEG 2000
       files (tests/fixtures/jpeg2000/). The full-width pair as RGB 9/7
       JP2 files (three layers, RPCL, 512x512 tiles from an odd tile
       offset) -> OBJ with --focal-length=43 and (f)'s gates but the
       in-memory run; (a)'s SEM
       pair as gray 9/7 codestreams -> PLY, byte-equal to reconstruct's
       on the decoded planes; BASELINE #3's views as lossless 5/3 RGB
       codestreams (LRCP, precincts) -> OBJ with --focal-length=43 and
       (f)'s gates; LA, RGBA, CMYK (.jp2 and .j2k), YCbCr, 16-bit,
       signed, PCRL, CPRL, RLCP, PLT, palette (P, PA) files and an ICNS
       with a JPEG 2000 entry decoded, each timed. Every plane has the
       committed SHA-256 of Pillow's ("jpeg2000"), the decode seconds of
       each plane printed;
   (s) with Pillow blocked as well (cli_depth_writers): (a)'s SEM TIFF
       pair -> .gif depth map, byte-equal to reconstruct's on the same
       planes; the RGBA that run's writer received through
       writers._save_image to .png, .apng, .ico and .icns, each timed and
       read back by the port's readers (the PNGs to that RGBA, the ICO's
       largest entry to its Lanczos thumbnail, the ICNS's to its 1024x1024
       bicubic resize, the GIF's colours to the octree palette's);
       depth_writer_rgba()'s seeded map through all five writers, each
       file with the committed SHA-256 of Pillow's bytes ("depth
       writers"; where zlib.ZLIB_RUNTIME_VERSION is not the version the
       hashes were made with, the PNG-bearing files are held by their
       inflated IDAT data and the bytes outside the deflate streams,
       deflate_free, and the line says so); the encode of a 1024x1024
       depth map (.png) and of BASELINE #4's 4032x3024 texture (level 1)
       timed;
   (t) with Pillow blocked as well (cli_jpeg2000_writers): (a)'s SEM TIFF
       pair -> .jp2 depth map, byte-equal to reconstruct's on the same
       planes and read back by the port's JPEG 2000 decoder to the RGBA
       that run's writer received; that RGBA through writers._save_image
       to .j2k, .j2c, .jpc, .jpf, .jpx and .pdf, each timed and read back
       to it (the PDF's JP2 stream); depth_writer_rgba()'s seeded map
       through the seven writers, each file with the committed SHA-256 of
       Pillow's bytes ("jpeg2000 writer"; the PDF's dates at PDF_CLOCK);
       the encode of an 898x1014 and a 1024x1024 depth map timed, best
       of 3;
   (u) with Pillow blocked as well (cli_webp_writer): (a)'s SEM TIFF
       pair -> .webp depth map, byte-equal to reconstruct's on the same
       planes and read back by the port's WebP reader (the alpha to the
       RGBA that run's writer received, exactly; the RGB the lossy
       decode, mean error on the opaque pixels under 4);
       depth_writer_rgba()'s seeded map, an opaque and a fully
       transparent copy through writers._save_image, each file with the
       committed SHA-256 of Pillow's bytes ("webp writer"); the encode of
       an 898x1014 and a 1024x1024 depth map timed, best of 3;
   (v) with Pillow blocked as well (cli_avif): the committed AVIF files
       (tests/fixtures/avif/). (a)'s SEM pair as 4:0:0 AVIF -> PLY,
       byte-equal to reconstruct's on the decoded planes; BASELINE #3's
       views as RGB 4:2:0 AVIF carrying EXIF focal length 43 and
       orientation 6 -> OBJ with no --focal-length and (f)'s gates;
       RGBA, 4:4:4, limited-range, lossless, tiled and sequence files
       decoded, each timed. Every plane has the committed SHA-256 of
       Pillow's ("avif"), the decode seconds of each plane printed.
       (v3) (cli_avif_kinds): the kinds the wheel's libavif encoder
       writes: (a)'s SEM pair as 2x2 grids of 512x512 tiles (4:2:0,
       matrix coefficients 1, quantizer matrices, film grain) -> PLY,
       byte-equal to reconstruct's on the decoded planes; one file per
       readable matrix code, 2x3 colour and alpha grids, quantizer matrix
       and film grain files decoded, every plane to the committed SHA-256
       of Pillow's ("avif kinds"); the files Pillow fails on refused; the
       decode seconds of each kind printed with the card.
   (x) with Pillow blocked as well (cli_avif_depth): (a)'s SEM pair as
       10-bit 4:0:0 AVIF -> PLY, byte-equal to reconstruct's on the
       decoded planes (K1 8 / K2 1 / K3 1); BASELINE #3's views as 12-bit
       RGBA 4:2:0 AVIF with a premultiplied alpha and EXIF focal 43 -> OBJ
       with no --focal-length and (f)'s gates (K1 6 / K2 20 / K3 20); every
       plane to the committed SHA-256 of Pillow's ("avif depth"), the
       decode seconds of each file printed.
   (y) with Pillow blocked as well (cli_avif_scale): (a)'s SEM pair coded
       at 910 columns and upscaled by superres (denominator 9) -> PLY,
       byte-equal to reconstruct's on the decoded planes (K1 8 / K2 1 /
       K3 1); small superres files (every denominator end, subsampling
       and depth, alpha, loop restoration, a grid) and files whose ispe
       makes libavif scale the frame decoded to the committed SHA-256 of
       Pillow's planes ("avif scale"), the frame libyuv cannot scale
       refused; one in-memory run with CVTPU_PROFILE set, whose
       torch.profiler trace must name K1's kernel.
   One JSON record per run: seconds, phases, decode seconds per file and
   plane, encode (and write) seconds per depth map, launches, the card's
   name and power limit.

Every phase prints the launches of K1/K2/K3 per run (counts set to 0
just before a run, read just after). The last two lines of standard
output are one JSON object per kernel record ({"kernels": [...]}) and
the device record ({"ok": true, ...}).
The script exits non-zero, printing neither, when there is no CUDA device
or any phase fails. It imports nothing of JAX and nothing of the JAX
package, and needs no Pillow: images are built in memory or written by
its own writers (write_tiff, write_bmp, write_gif, write_pgm16,
write_spider, write_tga_rle, write_png_text_exif, icon_files,
sun_raster, im_file, msp_file, xbm_file, xpm_file, arith_jpeg,
lossless_jpeg, huffman_jpeg, ojpeg_tiff, psd_file, fits_file, dcx_file,
gbr_file, imt_file, iptc_file, mcidas_file, pixar_file, xv_thumbnail,
dds_file, bc1_file, bc7_mode6_blocks, dxt5_blocks, dds_masked, blp1_file,
blp2_file, ftex_file, rgb_jpeg, fli_file, pcd_file, png_encode.encode_png) and the committed
fixtures (the JPEG 2000 files among them). It prints whether Pillow
is installed on the card's machine.
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import importlib.util
import io
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
from scipy import ndimage

SIZE = 1024
BATCH = 50_000  # RansacConfig.check_interval: candidates per RANSAC round
DRAW_ROUNDS = 13  # redraw rounds of _ransac_batch_core's sampling
GATHER_TURNS = 5
GATHER_PROFILED_CALLS = 50  # per turn, in the one profile
GATHER_HOST_CALLS = 1000  # per turn, timed on the host clock
WIDE_WINDOW = 192  # two chunks of offsets per stripe in K1's static forms
LARGE_H, LARGE_W = 3024, 4032  # BASELINE #4's pair: 12.2 Mpx
MAX_POINTS = 500_000  # BASELINE #4's --max-points
# Phase 6: tests/perspective_scene.py's views, focal length in pixels
# and extra cameras (pair_cam, third_cam: axis-angle rotation and
# translation; camera 1 is the identity), 43 mm as the 35 mm equivalent
# of its 400 px, and the full-width scale (1024x820).
PERSP_W, PERSP_H = 320, 256
PERSP_F = 400.0
PERSP_FOCAL_35MM = 43
PERSP_CAMS = (
    ((0.02, 0.12, -0.01), (1.2, 0.1, 0.2)),
    ((-0.015, -0.1, 0.012), (-1.1, -0.12, 0.15)),
)
FULL_SCALE = 3.2
# Phase 6's diagonal pair: camera 2 translated along both image axes at
# once, so the epipoles lie off the lower-right corner ((3564, 3437) and (3925, 3610)
# at 1024x820) and the epipolar lines cross the image at 38-54 degrees:
# the dominant axis changes across every level, none has a uniform sweep
# axis, and K1 runs its per-pixel form.
PERSP_CAM_DIAGONAL = ((0.03, 0.06, -0.01), (0.8, 0.75, 0.3))
# Camera pose gates, degrees: rotation and translation direction against
# the renderer's after aligning camera 1.
POSE_TOL_DEG = (1.0, 3.0)
# BASELINE #5 is held to the JAX package's own result on that scene at
# the default budgets (tools/baseline5_reference.py on the CPU), per extra
# camera, plus POSE_MARGIN_DEG: there the budget's F for views 1-2 puts
# the epipole 30.8 deg off before the dense phase, the pair of views 2-3
# fails at the default floor and bundle adjustment ends at these errors.
POSE_REF_BASELINE5 = ((1.318, 3.971), (1.073, 8.971))
POSE_MARGIN_DEG = 0.5
# The DLT's host float64 eigh against the card's float32 eigh + float64
# polish: largest relative gap of a dehomogenised point.
DLT_AGREE_REL = 1e-6
DEPTH_R_MIN = 0.9
# Device kernels of each wrapper, as the profiler names them.
KERNEL_NAMES = {
    "ncc_sweep": ("sweep_tile_kernel", "sweep_pixel_tile_kernel"),
    "score_candidates": ("score_split_kernel", "score_reduce_kernel"),
    "gather_packed": ("gather_packed_kernel",),
}
# Published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, and HBM3 bandwidth. Bounds are stated against these at 700 W.
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12
# tests/test_pallas_ncc.py:50-60
SWEEP_FLIP_MAX = 0.005
SWEEP_CORR_ATOL = 1e-4
SWEEP_POS_EQ_MIN = 0.995
SCORE_RTOL = 1e-5
# K1's work per evaluated hypothesis in the separable form that the plain
# version and the Pallas kernel use, _box11(img1 * warp): 1 product, 10
# row sums, 10 column sums. The warp's box statistics are counted apart,
# per stripe and pixel: 20 sums of w0, 20 of w0^2 and the square.
SWEEP_OPS_PER_EVAL = 21.0


@functools.lru_cache(maxsize=2)
def synth_sem_pair(h: int, w: int, seed: int = 0):
    """The bench's synthetic SEM pair (a copy of bench.synth_sem_pair) plus
    its planted disparity: img2(x, y) = img1(x + d, y). Cached (the
    12.2-Mpx pair takes seconds to make); callers do not write to it."""
    rng = np.random.RandomState(seed)
    base = rng.uniform(0, 255, (h, w))
    base = ndimage.gaussian_filter(base, 1.2)
    bumps = ndimage.gaussian_filter(rng.uniform(0, 255, (h, w)), 8.0)
    img1 = base * 0.6 + bumps * 0.4
    img1 = (img1 - img1.min()) / (img1.max() - img1.min()) * 255.0
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    disparity = 2.0 + 6.0 * (ys / h) ** 2 + 3.0 * np.sin(xs / w * 3.0)
    img2 = ndimage.map_coordinates(
        img1, [ys, xs + disparity], order=3, mode="nearest"
    )
    return (
        np.round(img1).astype(np.uint8),
        np.round(img2).astype(np.uint8),
        disparity,
    )


def mesh_ms(fn, mesh, reps: int, warm_up: bool = True) -> float:
    """Mean milliseconds per call of work spread over a mesh: one
    warm-up call (none when the caller has just made the same call),
    every mesh device synchronised, then `reps` calls
    between two events on the lead device's stream, the second recorded
    after the lead stream has waited for every other device's work."""
    import torch

    lead = mesh.lead
    others = [d for d in dict.fromkeys(mesh.devices) if d != lead]

    def sync_all():
        for d in dict.fromkeys(mesh.devices):
            torch.cuda.synchronize(d)

    if warm_up:
        fn()
    sync_all()
    stream = torch.cuda.current_stream(lead)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record(stream)
    for _ in range(reps):
        fn()
    for d in others:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(d))
        stream.wait_event(done)
    t1.record(stream)
    sync_all()
    return t0.elapsed_time(t1) / reps


def cuda_ms(fn, reps: int, warm_up: bool = True) -> float:
    """Mean milliseconds per call on the card: one warm-up call (none when
    the caller has just made the same call: a plain version's seconds-long
    call after its comparison), then `reps` calls between two CUDA
    events."""
    import torch

    if warm_up:
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """Least time for the work: bytes over HBM rate vs f32 operations
    over the f32 peak, whichever is larger."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / PEAK_F32_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_report() -> None:
    """Each kernel's registers, spills and static shared memory as ptxas
    reports them: csrc/*.cu compiled again with kernels.NVCC_FLAGS and
    -Xptxas -v, one nvcc per source, all started together."""
    from cybervision_tpu_torch import kernels

    with tempfile.TemporaryDirectory() as td:
        procs = [
            (src, subprocess.Popen(
                [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                 src, "-o", os.path.join(td, os.path.basename(src) + ".o")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for src in kernels._sources()
        ]
        for src, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc -Xptxas -v failed on {src}:\n{out}")
            fn = None
            for line in out.splitlines():
                if "Compiling entry function" in line:
                    fn = line.split("'")[1]
                elif fn and ("Used" in line or "spill" in line):
                    text = line.split(":", 1)[1] if line.startswith("ptxas") else line
                    print(f"ptxas {os.path.basename(src)} {fn}: {text.strip()}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return out[0]


# ---------------------------------------------------------------------------
# K1: the dense-correlation sweep


def _finest_prev_state(disparity, device):
    """The scale-1/2 state the finest level refines: every cell matched at
    the planted disparity, in full-resolution units."""
    import torch

    from cybervision_tpu_torch.ops.correlation import CorrelationState

    h, w = disparity.shape
    hp, wp = h // 2, w // 2
    qy, qx = np.mgrid[0:hp, 0:wp]
    x2 = np.clip(np.round(2 * qx - disparity[2 * qy, 2 * qx]), 0, w - 1)
    pos = np.stack([x2, 2 * qy], axis=-1).astype(np.int32)
    return CorrelationState(
        pos=torch.as_tensor(pos, device=device),
        corr=torch.ones((hp, wp), dtype=torch.float32, device=device),
        valid=torch.ones((hp, wp), dtype=torch.bool, device=device),
    )


def sweep_evaluations(fields: dict, axis, corridor_size, window, h2, w2,
                      min_stdev) -> dict:
    """What the sweep computes on these fields. n_eval: the hypotheses
    whose 11x11 product the sweep must compute, those that pass every mask
    tested before it (source band, candidate bounds, corridor, p_ok, the
    warp's min_stdev) — the data-dependent work. tile_votes: the (stripe,
    offset, tile) triples that the tiled kernel's block vote lets through
    (a tile computes the product for all its pixels once one admits the
    hypothesis). For the per-pixel form also the tiles that stage one
    band of w0 or two: those with a pixel that passes the masks that hold
    for every stripe, by the axes among their elements (the tile +- KS
    inside the plane)."""
    import torch
    import torch.nn.functional as F

    from cybervision_tpu_torch.ops import ncc_sweep as k1

    ks = k1.KS
    h, w = fields["avg1"].shape
    dev = fields["avg1"].device
    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    vert_b = fields["vert"] > 0.5
    off0 = torch.floor(fields["coeff"] * fields["center"] + fields["add"])
    box = k1._box11(torch.stack([fields["w0"], fields["w0"] * fields["w0"]]))
    pok = fields["p_ok"] > 0.5
    th, tw = k1.TILES[axis]
    pad = (0, -w % tw, 0, -h % th)

    def per_tile(m):
        t = F.pad(m.float(), pad)
        return t.reshape(-1, th, t.shape[1] // tw, tw).amax((1, 3)) > 0

    total = tiles = 0
    base_any = per_tile(torch.zeros_like(pok))
    for oi in range(fields["w0"].shape[0]):
        avg = box[0, oi] / k1.KPC
        sd = torch.sqrt(torch.clamp(box[1, oi] / k1.KPC - avg * avg, min=0.0))
        planes = torch.stack([fields["center"], off0, sd, fields["vert"]])
        for u in range(-window, window + 1):
            sh = {
                "vert": (k1.shift(planes, u, -2),
                         (rows + u >= ks) & (rows + u < h - ks)),
                "horiz": (k1.shift(planes, u, -1),
                          (cols + u >= ks) & (cols + u < w - ks)),
            }
            if axis is None:
                sl = torch.where(vert_b, sh["vert"][0], sh["horiz"][0])
                src_ok = torch.where(vert_b, sh["vert"][1], sh["horiz"][1])
            else:
                sl, src_ok = sh[axis]
            cen, off, sd_u, vert_u = sl.unbind(0)
            off = off + float(oi - corridor_size)
            is_vert = vert_b if axis is None else axis == "vert"
            qx = torch.where(is_vert, off, cen) if axis is None else (
                off if is_vert else cen)
            qy = torch.where(is_vert, cen, off) if axis is None else (
                cen if is_vert else off)
            base = src_ok & pok & (cen >= fields["start"]) & (cen < fields["end"])
            if axis is None:
                # The masks that hold for every stripe, as the kernel's
                # first vote tests them.
                base &= ((vert_u > 0.5) == vert_b) & (cen >= ks) & (
                    cen < torch.where(vert_b, h2, w2) - ks)
                if oi == 0:
                    base_any |= per_tile(base)
            ok = (
                base
                & (qx >= ks) & (qx < w2 - ks)
                & (qy >= ks) & (qy < h2 - ks)
                & (sd_u >= min_stdev)
            )
            total += int(ok.sum())
            tiles += int(per_tile(ok).sum())
    out = {"n_eval": total, "tile_votes": tiles}
    if axis is None:
        # Axes among each tile's elements inside the plane: zero padding
        # adds neither.
        pad_e = (ks, ks + pad[1], ks, ks + pad[3])
        kern = (th + 2 * ks, tw + 2 * ks)
        has = [F.max_pool2d(F.pad(m.float(), pad_e)[None, None], kern, (th, tw))[0, 0] > 0
               for m in (vert_b, ~vert_b)]
        bands = has[0].int() + has[1].int()
        out["tiles_one_band"] = int(((bands == 1) & base_any).sum())
        out["tiles_two_bands"] = int(((bands == 2) & base_any).sum())
        out["tiles"] = bands.numel()
    return out


def mixed_axes(fields: dict, kind: str, block: int = 64) -> dict:
    """The fields with the per-pixel axis set per pixel: vertical on a
    checkerboard of `block`-pixel squares, or below the diagonal from the
    top-left corner to the bottom-right one."""
    import torch

    h, w = fields["avg1"].shape
    yy, xx = np.mgrid[0:h, 0:w]
    vert = (yy // block + xx // block) % 2 if kind == "checker" else xx * h > yy * w
    return dict(fields, vert=torch.as_tensor(vert.astype(np.float32),
                                             device=fields["avg1"].device))


def check_sweep(fields: dict, axis, kw: dict, reps: int, label: str = "") -> dict:
    """K1 against its plain version on the same fields: the per-pixel form
    bit for bit, the static forms within K1's tolerances; reps > 0 also
    times both and states the bound. The per-pixel form prints its tile
    votes and the tiles that stage one band of w0 or two."""
    import torch

    from cybervision_tpu_torch.ops import ncc_sweep as k1

    args = list(fields.values())
    ck, xk, yk = k1.ncc_sweep(*args, axis=axis, **kw)
    cp, xp, yp = k1.ncc_sweep_plain(*args, axis=axis, **kw)
    torch.cuda.synchronize()
    exact = all(torch.equal(a, b) for a, b in ((ck, cp), (xk, xp), (yk, yp)))
    vk, vp = torch.isfinite(ck), torch.isfinite(cp)
    flip = float((vk != vp).float().mean())
    both = vk & vp
    err = float((ck - cp)[both].abs().max()) if bool(both.any()) else 0.0
    pos_eq = (
        float(((xk == xp) & (yk == yp))[both].float().mean())
        if bool(both.any()) else 1.0
    )
    valid_share = float(vp.float().mean())
    h, w = fields["avg1"].shape
    name = f"{axis or 'per-pixel'}{label}"
    if not (flip < SWEEP_FLIP_MAX and err <= SWEEP_CORR_ATOL
            and pos_eq > SWEEP_POS_EQ_MIN) or (axis is None and not exact):
        raise AssertionError(
            f"K1 {name}: valid flips {flip:.5f}, corr err {err:.3g},"
            f" positions equal {pos_eq:.5f}, bit-equal {exact}"
        )
    votes = ""
    if reps or axis is None:
        ev = sweep_evaluations(
            fields, axis, kw["corridor_size"], kw["window"], kw["h2"], kw["w2"],
            kw["min_stdev"],
        )
        th, tw = k1.TILES[axis]
        votes = (f"; evaluated hypotheses {ev['n_eval']}, tile votes passed"
                 f" {ev['tile_votes']}, i.e. {ev['tile_votes'] * th * tw}"
                 f" pixel-hypotheses computed"
                 f" ({ev['tile_votes'] * th * tw / max(ev['n_eval'], 1):.2f}x the evaluated ones)")
        if axis is None:
            votes += (f"; tiles staging one band {ev['tiles_one_band']}, two bands"
                      f" {ev['tiles_two_bands']}, of {ev['tiles']}")
    if not reps:
        print(f"K1 {name} at {h}x{w}, window {kw['window']}: valid"
              f" {valid_share:.4f}, flips {flip:.6f}, max|dcorr| {err:.3g},"
              f" positions equal {pos_eq:.6f}, bit-equal {exact}{votes}")
        return {"err": err, "exact": exact, "valid_share": valid_share}
    ms = cuda_ms(lambda: k1.ncc_sweep(*args, axis=axis, **kw), reps)
    plain_ms = cuda_ms(lambda: k1.ncc_sweep_plain(*args, axis=axis, **kw), 1, warm_up=False)
    n_o = fields["w0"].shape[0]
    # Inputs read once (the vert plane only by the per-pixel form), three
    # outputs written once.
    n_planes = 9 + (axis is None) + n_o + 3
    n_bytes = 4.0 * h * w * n_planes
    n_ops = SWEEP_OPS_PER_EVAL * ev["n_eval"] + 41.0 * n_o * h * w
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    print(
        f"K1 {name}: valid {valid_share:.4f}, flips {flip:.6f},"
        f" max|dcorr| {err:.3g}, positions equal {pos_eq:.6f}, bit-equal"
        f" {exact}; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms,"
        f" bound {b_ms:.4f} ms ({b_by}){votes}"
    )
    return {"err": err, "exact": exact, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "valid_share": valid_share,
            "n_eval": ev["n_eval"], "fields": fields, "axis": axis}


def sweep_case(device, axis: str, h: int, w: int, window: int | None = None):
    """K1's fields and arguments for the finest level of the synthetic SEM
    pair at h x w: rows are its epipolar lines (horizontal shift), and the
    transposed pair (w x h) has vertical ones."""
    import torch

    from cybervision_tpu_torch.config import CorrelationConfig, ProjectionMode
    from cybervision_tpu_torch.ops import correlation as corr

    cc = CorrelationConfig()
    aff = ProjectionMode.AFFINE
    cs = cc.corridor_size(aff)
    a, b, d = synth_sem_pair(h, w)
    f = np.array([[0, 0, 0], [0, 0, 1], [0, -1, 0]], np.float64)
    if axis == "vert":
        swap = np.array([[0, 1, 0], [1, 0, 0], [0, 0, 1]], np.float64)
        a, b, d, f = a.T.copy(), b.T.copy(), d.T.copy(), swap @ f @ swap
    hh, ww = a.shape
    kw = dict(
        threshold=cc.threshold(aff), min_stdev=cc.min_stdev(aff),
        window=window or cc.corridor_window_fixed, corridor_size=cs,
        h2=hh, w2=ww,
    )
    wtr, tmin = corr.split_trange(corr.warp_shift_range(f, 1.0, hh, ww, hh, ww))
    if wtr is None or wtr[0] != axis:
        raise AssertionError(f"K1 {axis}: warp bucket {wtr}")
    fields = corr.sweep_inputs(
        torch.as_tensor(a, device=device), torch.as_tensor(b, device=device),
        _finest_prev_state(d, device),
        torch.as_tensor(f, dtype=torch.float32, device=device),
        1.0, kw["min_stdev"], cc.corridor_min_range(aff),
        cc.corridor_extend_range(aff), cs, wtr, tmin, axis,
    )
    return fields, kw


def phase_sweep(device) -> dict:
    out = {}
    for axis in ("horiz", "vert"):
        fields, kw = sweep_case(device, axis, SIZE, SIZE)
        out[axis] = check_sweep(fields, axis, kw, reps=5)
        if out[axis]["valid_share"] < 0.3:
            raise AssertionError(f"K1 {axis}: only {out[axis]['valid_share']:.3f} valid")
        if axis == "horiz":
            # Per-pixel form: the same fields with the axis flipped to
            # vertical on a checkerboard of 64-pixel blocks, so the kernel
            # chooses the sweep axis per pixel, per window element, and
            # rejects hypotheses sourced across an axis boundary.
            out["per-pixel"] = check_sweep(mixed_axes(fields, "checker"), None, kw, reps=3)
    return out


def phase_sweep_wide(device, mesh) -> list[dict]:
    """K1's three forms at 1024x1024 and window 192, which sweep each
    stripe's offsets in chunks (the per-pixel form on phase 2's
    checkerboard of axes): bit-equal to the plain version and timed;
    then the row-halo form (K1s) at 192 over the mesh, bit-equal to its
    plain version and to the unsharded kernel."""
    from cybervision_tpu_torch.ops import ncc_sweep as k1

    res = []
    for axis in ("horiz", "vert", None):
        fields, kw = sweep_case(device, axis or "horiz", SIZE, SIZE, WIDE_WINDOW)
        if axis is None:
            fields = mixed_axes(fields, "checker")
        chunks = k1.sweep_tile_plan(SIZE, SIZE, WIDE_WINDOW, axis)["chunks"]
        r = check_sweep(fields, axis, kw, reps=3, label=f" at window {WIDE_WINDOW}")
        print(f"K1 {axis or 'per-pixel'} at window {WIDE_WINDOW}: chunks {chunks}")
        if not r["exact"]:
            raise AssertionError(f"K1 {axis} at window {WIDE_WINDOW}: not bit-equal to the plain version")
        res.append(r)
        if axis == "horiz":
            s = check_sweep_sharded(mesh, r, kw, reps=1)
            if not s["exact"]:
                raise AssertionError(f"K1s at window {WIDE_WINDOW}: not bit-equal to the plain version")
            res.append(s)
    return res


def phase_sweep_awkward(device) -> list[dict]:
    """K1's three forms off the tile grid (999x777) and at the window
    buckets' ends (8 and 128, on a 300x280 plane), the per-pixel form with
    its axis flipping across the diagonal: checked, not timed."""
    res = []
    for axis in ("horiz", "vert", None):
        for h, w, window in ((999, 777, None), (300, 280, 8), (300, 280, 128)):
            fields, kw = sweep_case(device, axis or "horiz", h, w, window)
            if axis is None:
                fields = mixed_axes(fields, "diagonal")
            res.append(check_sweep(fields, axis, kw, 0))
    return res


# ---------------------------------------------------------------------------
# K2 and K3: RANSAC scoring and sampling


def ransac_tables(matches: np.ndarray, m_bucket: int, device):
    """The main path's RANSAC inputs for a match table padded (or cut) to
    m_bucket rows: p1, p2, m_valid, the packed table and top_limit."""
    import torch

    from cybervision_tpu_torch.config import RansacConfig
    from cybervision_tpu_torch.ops.epipolar import pack_coord_table

    m = min(len(matches), m_bucket)
    mpad = np.zeros((m_bucket, 4), np.int64)
    mpad[:m] = matches[:m]
    p1 = torch.as_tensor(mpad[:, 0:2], dtype=torch.float32, device=device)
    p2 = torch.as_tensor(mpad[:, 2:4], dtype=torch.float32, device=device)
    m_valid = torch.as_tensor(np.arange(m_bucket) < m, device=device)
    packed = torch.as_tensor(pack_coord_table(mpad), device=device)
    return p1, p2, m_valid, packed, min(m, RansacConfig().top_inliers)


def check_score(matches, m_bucket, device, gen, c=BATCH, mask="",
                reps=5) -> dict:
    """K2 against its plain version: counts equal, sums within rtol 1e-5.
    mask "holes" clears rows in the middle of the valid ones, "none"
    clears them all; reps > 0 also times both and states the bound."""
    import torch

    from cybervision_tpu_torch.config import ProjectionMode, RansacConfig
    from cybervision_tpu_torch.ops import score as k2
    from cybervision_tpu_torch.ops.epipolar import solve_affine_batch

    rc = RansacConfig()
    t = rc.params(ProjectionMode.AFFINE)[2]
    p1, p2, m_valid, _, top_limit = ransac_tables(matches, m_bucket, device)
    idx = torch.randint(0, top_limit, (c, 4), generator=gen, device=device)
    ff, _ = solve_affine_batch(p1[idx], p2[idx], rc.rank_epsilon)
    ff = ff.contiguous()
    if mask == "holes":
        n = int(m_valid.sum())
        m_valid = m_valid.clone()
        m_valid[n // 5 : n // 5 + 700] = False
        m_valid[n // 2 : n // 2 + 31] = False
    elif mask == "none":
        m_valid = torch.zeros_like(m_valid)
    ck, sk = k2.score_candidates(ff, p1, p2, m_valid, t)
    cp, sp = k2.score_candidates_plain(ff, p1, p2, m_valid, t)
    torch.cuda.synchronize()
    label = f"K2 C={c} M={m_bucket}{' mask ' + mask if mask else ''}"
    if not torch.equal(ck, cp):
        raise AssertionError(f"{label}: {int((ck != cp).sum())} counts differ")
    if not torch.allclose(sk, sp, rtol=SCORE_RTOL, atol=0.0):
        raise AssertionError(f"{label}: error sums beyond rtol {SCORE_RTOL}")
    if mask == "none" and (int(ck.abs().sum()) or float(sk.abs().sum())):
        raise AssertionError(f"{label}: counts or sums not 0")
    err = float((sk - sp).abs().max())
    if not reps:
        print(f"{label}: counts equal (max {int(ck.max())}), max|dsum| {err:.3g}")
        return {"err": err}
    ms = cuda_ms(lambda: k2.score_candidates(ff, p1, p2, m_valid, t), reps)
    plain_ms = cuda_ms(
        lambda: k2.score_candidates_plain(ff, p1, p2, m_valid, t), 1, warm_up=False
    )
    # Sampson error per (candidate, valid match): 5 linear forms (4 ops
    # each), the bilinear form (4), its square (1), the denominator (7),
    # the quotient (1), the threshold test and the masked sum (3). Rows
    # whose mask is clear need no work.
    m_work = int(m_valid.sum())
    n_ops = 36.0 * c * m_work
    n_bytes = c * 9 * 4 + m_bucket * (4 * 4 + 1) + c * 8
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    print(
        f"{label}: counts equal (max {int(ck.max())}),"
        f" max|dsum| {err:.3g}; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms,"
        f" bound {b_ms:.4f} ms ({b_by}, {m_work} valid rows)"
    )
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by}


def check_gather(matches, m_bucket, device, gen) -> dict:
    import torch

    from cybervision_tpu_torch.ops import gather as k3

    _, _, _, packed, top_limit = ransac_tables(matches, m_bucket, device)
    idx = torch.randint(
        0, top_limit, (DRAW_ROUNDS, 4, BATCH), generator=gen, device=device,
        dtype=torch.int32,
    )
    out_k = k3.gather_packed(packed, idx)
    out_p = k3.gather_packed_plain(packed, idx)
    flat = idx.reshape(-1)
    out_l = torch.index_select(packed, 1, flat).reshape(out_p.shape)
    out_pub = gather_public_path(packed, idx)
    torch.cuda.synchronize()
    if not all(torch.equal(o, out_p) for o in (out_k, out_l, out_pub)):
        raise AssertionError(f"K3 M={m_bucket}: gathers differ")
    calls = {"kernel": lambda: k3.gather_packed(packed, idx),
             "library": lambda: torch.index_select(packed, 1, flat)}
    # The kernel and index_select in turns, 200 calls a turn: at tens of
    # microseconds a call, separate runs measure the host as much as the
    # card.
    turns = {"kernel": [], "library": []}
    for _ in range(GATHER_TURNS):
        for who, fn in calls.items():
            turns[who].append(cuda_ms(fn, 200))
    ms = float(np.median(turns["kernel"]))
    lib_ms = float(np.median(turns["library"]))
    dev_us = gather_device_us(calls)
    # Host time also of the same launch through the public host path
    # (gather_public_path): what the wrapper's trimmed path saves.
    host_calls = dict(calls, public=lambda: gather_public_path(packed, idx))
    host = {who: [] for who in host_calls}
    for _ in range(GATHER_TURNS):
        for who, fn in host_calls.items():
            host[who].append(host_us(fn, GATHER_HOST_CALLS))
    host_med = {who: tuple(float(np.median([t[i] for t in v])) for i in range(2))
                for who, v in host.items()}
    plain_ms = cuda_ms(lambda: k3.gather_packed_plain(packed, idx), 20)
    k = idx.numel()
    n_bytes = 4.0 * k + 4.0 * packed.numel() + 8.0 * k
    b_ms, b_by = bound_ms(n_bytes, 0.0)
    print(
        f"K3 M={m_bucket}: exact; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
        f" index_select {lib_ms:.4f} ms (CUDA events around 200 calls, medians"
        f" of {GATHER_TURNS} turns: kernel {[round(x, 5) for x in turns['kernel']]},"
        f" index_select {[round(x, 5) for x in turns['library']]}), bound"
        f" {b_ms:.4f} ms ({b_by})"
    )
    print(
        f"K3 M={m_bucket} per call: device {dev_us['kernel']['mean']:.3f} us"
        f" (events {dev_us['kernel']['events']}, median {dev_us['kernel']['median']:.3f})"
        f" vs index_select {dev_us['library']['mean']:.3f} us (events"
        f" {dev_us['library']['events']}, median {dev_us['library']['median']:.3f},"
        f" kernels {dev_us['library']['names']}); host {host_med['kernel'][0]:.3f} us"
        f" to enqueue, {host_med['kernel'][1]:.3f} us with the queue drained, vs"
        f" index_select {host_med['library'][0]:.3f} / {host_med['library'][1]:.3f} us,"
        f" public host path {host_med['public'][0]:.3f} / {host_med['public'][1]:.3f} us"
        f" (medians of {GATHER_TURNS} turns of {GATHER_HOST_CALLS} calls: kernel"
        f" {[round(t[0], 3) for t in host['kernel']]}, index_select"
        f" {[round(t[0], 3) for t in host['library']]}, public host path"
        f" {[round(t[0], 3) for t in host['public']]})"
    )
    return {"err": 0.0, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "device_us_per_call": dev_us["kernel"]["mean"],
            "library_device_us_per_call": dev_us["library"]["mean"],
            "host_us_per_call": host_med["kernel"][0],
            "library_host_us_per_call": host_med["library"][0],
            "public_host_us_per_call": host_med["public"][0]}


def gather_public_path(table, idx):
    """K3's launch through PyTorch's public host API, for timing beside
    ops.gather.gather_packed: the library looked up per call, a
    torch.cuda.device context and a torch.cuda.Stream object for the
    stream, around the same C entry point. Counts no launch."""
    import torch

    from cybervision_tpu_torch import kernels

    lib = kernels.library()
    tbl = table.contiguous()
    flat = idx.contiguous()
    out = torch.empty((2,) + tuple(idx.shape), dtype=torch.int32, device=idx.device)
    with torch.cuda.device(idx.device):
        kernels.check(
            lib.cv_gather_packed(
                tbl.data_ptr(), tbl.shape[1], flat.data_ptr(), flat.numel(),
                out.data_ptr(), torch.cuda.current_stream(idx.device).cuda_stream,
            ),
            "cv_gather_packed",
        )
    return out


def host_us(fn, calls: int) -> tuple[float, float]:
    """Host microseconds per call: perf_counter around `calls` calls with
    no sync (the time to enqueue them), and with the queue drained."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (t1 - t0) / calls * 1e6, (t2 - t0) / calls * 1e6


def gather_device_us(calls: dict) -> dict:
    """Device microseconds per call of K3 ("kernel") and index_select
    ("library"), from one torch.profiler profile that runs them in turns
    (GATHER_TURNS turns of GATHER_PROFILED_CALLS calls, a sync between
    turns): the device events of K3's kernel, and every other device
    event (index_select's kernels), summed over each one's calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(GATHER_TURNS):
            for fn in calls.values():
                for _ in range(GATHER_PROFILED_CALLS):
                    fn()
                torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {}
    for who in calls:
        mine = [e for e in kernels
                if any(k in e.name for k in KERNEL_NAMES["gather_packed"]) == (who == "kernel")]
        durs = [e.time_range.end - e.time_range.start for e in mine]
        n_calls = GATHER_TURNS * GATHER_PROFILED_CALLS
        out[who] = {"mean": sum(durs) / n_calls if durs else float("nan"),
                    "median": float(np.median(durs)) if durs else float("nan"),
                    "events": len(durs), "names": sorted({e.name[:40] for e in mine})}
    return out


def check_draws(device) -> dict:
    """One RANSAC round's draws, utils.prng.randint((13, 4, 50,000)) from a
    round key: equal on the card and on the CPU; ms per call beside
    torch.randint, the draw the threefry port replaced."""
    import torch

    from cybervision_tpu_torch.utils import prng

    key = prng.split(prng.prng_key(0))[1]
    shape = (DRAW_ROUNDS, 4, BATCH)
    top = 13_066
    out = prng.randint(key, shape, 0, top, device=device)
    same = torch.equal(out.cpu(), prng.randint(key, shape, 0, top))
    ms = cuda_ms(lambda: prng.randint(key, shape, 0, top, device=device), 20)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    old_ms = cuda_ms(lambda: torch.randint(0, top, shape, generator=gen, device=device,
                                           dtype=torch.int32), 20)
    print(f"draws of one RANSAC round {shape}: card equals CPU {same};"
          f" threefry {ms:.4f} ms per call vs torch.randint {old_ms:.4f} ms")
    if not same:
        raise AssertionError("the card's threefry draws differ from the CPU's")
    return {"ms": ms, "torch_randint_ms": old_ms}


def phase_ransac_all_rounds(matches, device, counters) -> dict:
    """find_fundamental_matrix on the main path's matches with an early
    exit no count reaches (RansacConfig.ransac_d_early_exit_affine above
    the match count), so every one of the 1,000,000 / 50,000 = 20 rounds
    runs: seconds (best of 2 warm runs), K2 and K3 launches per run (set
    to 0 just before, read just after), and their device milliseconds in
    one more run under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cybervision_tpu_torch.config import ProjectionMode, RansacConfig
    from cybervision_tpu_torch.ops.epipolar import find_fundamental_matrix

    cfg = RansacConfig(ransac_d_early_exit_affine=10**9)
    aff = ProjectionMode.AFFINE
    rounds = cfg.ransac_k_affine // cfg.check_interval
    secs, res = [], None
    for _ in range(2):
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        t0 = time.perf_counter()
        res = find_fundamental_matrix(matches, aff, float(SIZE), cfg, device=device, mesh=None)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        launches = {n: getattr(mod, attr) for n, (mod, attr) in counters.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        find_fundamental_matrix(matches, aff, float(SIZE), cfg, device=device, mesh=None)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_ms = {name: device_ms_by_kernel(prof)[1][name] for name in counters}
    busy = device_busy_us(prof)[0] / 1e3
    print(f"RANSAC, all {rounds} rounds (no early exit): best of 2 {min(secs):.4f} s"
          f" (runs {[round(x, 4) for x in secs]}), launches {launches}; profiled run:"
          f" wall {wall_ms:.3f} ms, device busy {busy:.3f} ms, device ms by wrapper"
          f" {json.dumps(dev_ms)}; winner {res.matches_count} inliers of"
          f" {len(matches)} matches")
    for name, n in launches.items():
        if n != rounds:
            raise AssertionError(f"{name} launched {n} times in {rounds} rounds")
    return {"seconds": min(secs), "launches": launches, "device_ms": dev_ms}


def main_path_matches(img1, img2, device) -> np.ndarray:
    """The sparse phase of the main path (ORB + matching, no kernel), for
    the RANSAC kernels' inputs."""
    from cybervision_tpu_torch.config import ProjectionMode, ReconstructionConfig
    from cybervision_tpu_torch.ops.features import extract_keypoints_pyramid_packed
    from cybervision_tpu_torch.ops.matching import match_keypoints_packed

    cfg = ReconstructionConfig()
    p1, p2 = extract_keypoints_pyramid_packed([img1, img2], cfg.orb, device)
    matches, _, _ = match_keypoints_packed(
        p1, p2, cfg.matching.threshold(ProjectionMode.AFFINE)
    )
    return matches


# ---------------------------------------------------------------------------
# Phase 4: the multi-device path


SHARDS_ON_ONE_CARD = 4


def chip_mesh():
    """Every visible card when there are two or more, else four row
    shards on the one card."""
    import torch

    from cybervision_tpu_torch.parallel import Mesh

    n = torch.cuda.device_count()
    if n >= 2:
        return Mesh(tuple(torch.device("cuda", i) for i in range(n)))
    return Mesh((torch.device("cuda", 0),) * SHARDS_ON_ONE_CARD)


def check_sweep_sharded(mesh, swept: dict, kw: dict, reps: int) -> dict:
    """K1s on phase 2's fields of one form: exactly the unsharded K1, and
    its sharded plain version within K1's tolerances; timed with the
    halo exchange."""
    import torch

    from cybervision_tpu_torch.ops import ncc_sweep as k1
    from cybervision_tpu_torch.parallel import gather_rows

    fields, axis = swept["fields"], swept["axis"]
    args = list(fields.values())
    lead = mesh.lead

    def run(plain=False):
        return [gather_rows(o, lead) for o in k1.ncc_sweep_sharded(
            mesh, *args, axis=axis, plain=plain, **kw)]

    single = k1.ncc_sweep(*args, axis=axis, **kw)
    out = run()
    ref = run(plain=True)
    for d in dict.fromkeys(mesh.devices):
        torch.cuda.synchronize(d)
    name = axis or "per-pixel"
    v1, v0 = torch.isfinite(out[0]), torch.isfinite(single[0])
    flips = int((v1 != v0).sum())
    both = v1 & v0
    d_corr = float((out[0] - single[0])[both].abs().max()) if bool(both.any()) else 0.0
    pos_same = bool(torch.equal(out[1], single[1]) and torch.equal(out[2], single[2]))
    if not (flips == 0 and torch.equal(out[0], single[0]) and pos_same):
        raise AssertionError(
            f"K1s {name}: not equal to the unsharded K1 ({flips} valid flips,"
            f" max|dcorr| {d_corr:.3g}, positions equal {pos_same})"
        )
    exact = all(torch.equal(a, b) for a, b in zip(out, ref))
    vp = torch.isfinite(ref[0])
    flip = float((v1 != vp).float().mean())
    both = v1 & vp
    err = float((out[0] - ref[0])[both].abs().max()) if bool(both.any()) else 0.0
    pos_eq = (
        float(((out[1] == ref[1]) & (out[2] == ref[2]))[both].float().mean())
        if bool(both.any()) else 1.0
    )
    if not (flip < SWEEP_FLIP_MAX and err <= SWEEP_CORR_ATOL
            and pos_eq > SWEEP_POS_EQ_MIN) or (axis is None and not exact):
        raise AssertionError(
            f"K1s {name} vs plain: valid flips {flip:.5f}, corr err {err:.3g},"
            f" positions equal {pos_eq:.5f}, bit-equal {exact}"
        )
    ms = mesh_ms(lambda: k1.ncc_sweep_sharded(mesh, *args, axis=axis, **kw), mesh, reps)
    plain_ms = mesh_ms(
        lambda: k1.ncc_sweep_sharded(mesh, *args, axis=axis, plain=True, **kw), mesh, 1,
        warm_up=False,
    )
    h, w = fields["avg1"].shape
    n_o = fields["w0"].shape[0]
    n, hs = mesh.size, -(-h // mesh.size)
    m_w0 = k1.KS + kw["window"]
    # K1's work (phase 2) plus the halo exchange: per shard, KS rows of
    # img1 above and below, `window` of vert/center/coeff/add, KS + window
    # of every stripe's warp, each read once and written once; and the
    # warp box sums over every shard's haloed planes.
    halo_rows = 2 * k1.KS + 4 * 2 * kw["window"] + n_o * 2 * m_w0
    n_bytes = 4.0 * h * w * (9 + (axis is None) + n_o + 3) + 8.0 * w * n * halo_rows
    n_ops = SWEEP_OPS_PER_EVAL * swept["n_eval"] + 41.0 * n_o * n * (hs + 2 * m_w0) * w
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    print(
        f"K1s {name} over {mesh.describe()}, window {kw['window']}: equal to K1"
        f" (0 flips, |dcorr| 0, positions equal); vs sharded plain: flips"
        f" {flip:.6f}, max|dcorr| {err:.3g}, positions equal {pos_eq:.6f},"
        f" bit-equal {exact};"
        f" {ms:.3f} ms per call with the halo exchange, plain {plain_ms:.1f} ms,"
        f" bound {b_ms:.4f} ms ({b_by})"
    )
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "exact": exact}


def phase_mesh_sweep(mesh, sweep: dict) -> dict:
    from cybervision_tpu_torch.config import CorrelationConfig, ProjectionMode

    cc = CorrelationConfig()
    aff = ProjectionMode.AFFINE
    kw = dict(
        threshold=cc.threshold(aff), min_stdev=cc.min_stdev(aff),
        window=cc.corridor_window_fixed, corridor_size=cc.corridor_size(aff),
        h2=SIZE, w2=SIZE,
    )
    return {form: check_sweep_sharded(mesh, swept, kw, reps=3)
            for form, swept in sweep.items()}


def check_mesh_launches(e2e: dict, n: int) -> None:
    """Launches of a run under an n-shard mesh against its plan: two
    sweeps (forward, reverse) per refine level, n K1 launches for each
    sharded one; K2 and K3 once per shard per RANSAC round."""
    levels = e2e["plan"]["sharded_levels"][1:]
    sharded = 2 * sum(levels)
    single = 2 * (len(levels) - sum(levels))
    got = e2e["launches"]
    if not (e2e["plan"]["mesh"] and got["ncc_sweep_sharded"] == sharded > 0):
        raise AssertionError(f"sharded sweeps {got['ncc_sweep_sharded']}, plan {e2e['plan']}")
    if got["ncc_sweep"] != n * sharded + single:
        raise AssertionError(f"K1 launched {got['ncc_sweep']} times, want {n * sharded + single}")
    for name in ("score_candidates", "gather_packed"):
        if got[name] == 0 or got[name] % n:
            raise AssertionError(f"{name} launched {got[name]} times over {n} shards")


def check_sharded_plan(label: str, plan: dict, shape1, shape2, mesh) -> None:
    """A correlate_images plan under `mesh`: every level whose rows shard
    (correlation.prologue_shardable, both images) ran row-sharded from
    resize to cross-check, the others on the lead; some refine level's
    sweeps ran as K1s."""
    from cybervision_tpu_torch.config import CorrelationConfig, pyramid_scales
    from cybervision_tpu_torch.ops import correlation

    scales = pyramid_scales(shape1[::-1], CorrelationConfig().scale_min_size)
    want = [all(correlation.prologue_shardable(correlation.resized_shape(sh, s)[0], mesh.size)
                for sh in (shape1, shape2)) for s in scales]
    if not (plan["mesh"] and plan["sharded_prologue"] == want and any(plan["sharded_levels"])):
        raise AssertionError(f"{label}: plan {plan}, want sharded levels {want}")


def phase_same_correlation(img1, img2, matches, mesh, device) -> None:
    """correlate_images under the mesh for the F of an unsharded RANSAC
    run: its delta and word planes equal the unsharded run's, and every
    level deep enough ran row-sharded."""
    import torch

    from cybervision_tpu_torch.config import CorrelationConfig, ProjectionMode
    from cybervision_tpu_torch.images import SourceImage
    from cybervision_tpu_torch.ops import correlation
    from cybervision_tpu_torch.ops.epipolar import find_fundamental_matrix

    aff = ProjectionMode.AFFINE
    f = find_fundamental_matrix(matches, aff, float(SIZE), device=device, mesh=None).f
    src = [SourceImage(im) for im in (img1, img2)]
    cc = CorrelationConfig()
    single = correlation.correlate_images(
        *src, f, aff, cc, device_out="delta", device=device, mesh=None)
    sharded = correlation.correlate_images(
        *src, f, aff, cc, device_out="delta", device=device, mesh=mesh)
    plan = correlation._LAST_PLAN
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(single, sharded))
    valid = float(((single[0] >> 14) & 1).float().mean())
    print(f"correlate_images under the mesh, F of an unsharded run: delta and"
          f" word planes equal {same} (valid share {valid:.4f}, plan {plan})")
    if not same:
        raise AssertionError("the sharded correlation differs from the unsharded one")
    check_sharded_plan("correlate_images under the mesh", plan, img1.shape, img2.shape, mesh)


# ---------------------------------------------------------------------------
# End to end


def read_ply_vertices(path: str) -> np.ndarray:
    """(N, 3) float64 vertex coordinates of the native writer's binary
    big-endian PLY (x, y, z doubles, then r, g, b bytes)."""
    with open(path, "rb") as fh:
        data = fh.read()
    head, _, body = data.partition(b"end_header\n")
    n = int(head.split(b"element vertex ")[1].split(b"\n")[0])
    rec = np.frombuffer(
        body[: n * 27], dtype=[("xyz", ">f8", 3), ("rgb", "u1", 3)]
    )
    return rec["xyz"].astype(np.float64)


def reconstruct_runs(images, cfg, out: str, counters, warm: int):
    """One cold (or warm-up) run of reconstruct on the in-memory images,
    then `warm` timed runs, each with the kernels' launch counts set to
    0 just before and read just after; every card synchronised before a
    clock stops. Returns (first run's seconds, [(seconds, phases,
    launches)])."""
    import torch

    from cybervision_tpu_torch.reconstruction import reconstruct

    names = ["synth_a.png", "synth_b.png"]

    def sync():
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)

    t0 = time.perf_counter()
    reconstruct(names, out, cfg, quiet=True, images=images)
    sync()
    first_s = time.perf_counter() - t0
    runs = []
    for _ in range(warm):
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        t0 = time.perf_counter()
        phases = reconstruct(names, out, cfg, quiet=True, images=images)
        sync()
        dt = time.perf_counter() - t0
        runs.append((dt, phases, {name: getattr(mod, attr)
                                  for name, (mod, attr) in counters.items()}))
    return first_s, runs


def report_runs(label: str, first: str, first_s: float, runs) -> tuple:
    """Print the runs' seconds, the best run's phases and the launches per
    run; fail when a kernel was not launched or the counts vary.
    Returns the best run (seconds, phases, launches)."""
    best = min(runs, key=lambda r: r[0])
    if any(r[2] != runs[0][2] for r in runs):
        raise AssertionError(f"{label}: launch counts vary between runs: {[r[2] for r in runs]}")
    print(f"{label}: {first} {first_s:.3f} s, warm best of {len(runs)} {best[0]:.3f} s"
          f" (runs {[round(r[0], 4) for r in runs]})")
    print(f"{label}: phases of the best run " + json.dumps(
        {k: round(v, 4) for k, v in best[1].items()}))
    print(f"{label}: launches per run {best[2]}")
    for name, n in best[2].items():
        if n == 0:
            raise AssertionError(f"{label}: the path never launched {name}")
    return best


def phase_end_to_end(img1, img2, disparity, counters, mesh=None,
                     label="end to end") -> dict:
    """The main path through reconstruct, under `mesh` (None: the
    single-card path): one warm-up run, then three timed runs.
    counters: kernel name -> (module, attribute) of its launch count."""
    from cybervision_tpu_torch.config import (
        MeshMode, ProjectionMode, ReconstructionConfig,
    )
    from cybervision_tpu_torch.images import SourceImage
    from cybervision_tpu_torch.ops import correlation
    from cybervision_tpu_torch.parallel import use_mesh

    cfg = ReconstructionConfig(
        projection=ProjectionMode.AFFINE, mesh=MeshMode.VERTEX_COLORS
    )
    # In memory, the colour plane is the gray one repeated: PIL's
    # convert("RGB") of an "L" image.
    images = [SourceImage(im) for im in (img1, img2)]
    with tempfile.TemporaryDirectory() as td, use_mesh(mesh):
        out = os.path.join(td, "mesh.ply")
        cold_s, runs = reconstruct_runs(images, cfg, out, counters, 3)
        xyz = read_ply_vertices(out)
    plan = dict(correlation._LAST_PLAN)
    best_s, phases, launches = report_runs(label, "cold", cold_s, runs)
    print(f"{label}: correlation plan {plan}")

    n = len(xyz)
    share = n / float(SIZE * SIZE)
    xs = np.clip(np.round(xyz[:, 0]).astype(int), 0, SIZE - 1)
    ys = np.clip(np.round(-xyz[:, 1]).astype(int), 0, SIZE - 1)
    depth = -xyz[:, 2]  # the default --scale=-1 flips z
    truth = disparity[ys, xs]
    r = float(np.corrcoef(depth, truth)[0, 1])
    med = float(np.median(np.abs(depth - truth)))
    print(f"PLY: {n} vertices ({share:.3f} of the pixels), depth vs planted"
          f" disparity: r {r:.4f}, median |err| {med:.3f} px")
    if not np.all(np.isfinite(xyz)):
        raise AssertionError("non-finite vertices")
    if share <= 0.3:
        raise AssertionError(f"only {share:.3f} of the pixels became vertices")
    if r < 0.9 or med > 1.0:
        raise AssertionError(f"depth does not track the disparity (r {r:.3f}, median {med:.3f})")
    return {"seconds": best_s, "launches": launches, "plan": plan, "phases": phases,
            "xyz": xyz}


def device_events(prof) -> list[tuple[str, float, float]]:
    """(name, start us, end us) of every device event of a profiled
    window, read from the raw kineto results: prof.events() first builds
    the whole host/device event tree, tens of seconds for the ~10^5
    events of a perspective run."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [
        (e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
        for e in prof.profiler.kineto_results.events() if e.device_type() == cuda
    ]


def device_ms_by_kernel(prof) -> tuple[dict[str, float], dict[str, float]]:
    """Device milliseconds of a profiled window per kernel name, and per
    wrapper (KERNEL_NAMES), summed over the raw device events
    (key_averages over ~10^5 events costs tens of seconds)."""
    durs: dict[str, float] = {}
    for name, start, end in device_events(prof):
        durs[name] = durs.get(name, 0.0) + (end - start) / 1e3
    per_wrapper = {name: sum(v for k, v in durs.items() if any(n in k for n in keys))
                   for name, keys in KERNEL_NAMES.items()}
    return durs, per_wrapper


def device_busy_us(prof) -> tuple[float, int]:
    """Microseconds in which the card ran at least one kernel during a
    profiled window (the union of its device events), and their count."""
    spans = sorted((s, e) for _, s, e in device_events(prof))
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy, len(spans)


def profile_end_to_end(img1, img2, mesh=None, label="profile", cfg=None,
                       out_name="mesh.ply") -> dict:
    """One warm run of reconstruct under torch.profiler (under `mesh`;
    None: the single-card path), of `cfg` (default: the main path's PLY
    config) to `out_name`: the card's busy share of the run (union of
    device-event intervals over the host wall time), the kernels by
    device time, and each wrapper's kernels' device milliseconds in the
    run (KERNEL_NAMES)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cybervision_tpu_torch.config import (
        MeshMode, ProjectionMode, ReconstructionConfig,
    )
    from cybervision_tpu_torch.images import SourceImage
    from cybervision_tpu_torch.parallel import use_mesh
    from cybervision_tpu_torch.reconstruction import reconstruct

    cfg = cfg or ReconstructionConfig(
        projection=ProjectionMode.AFFINE, mesh=MeshMode.VERTEX_COLORS
    )
    images = [SourceImage(im) for im in (img1, img2)]
    names = ["synth_a.png", "synth_b.png"]
    with tempfile.TemporaryDirectory() as td, use_mesh(mesh):
        out = os.path.join(td, out_name)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            reconstruct(names, out, cfg, quiet=True, images=images)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    busy, n_events = device_busy_us(prof)
    print(f"{label}: wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms"
          f" ({busy / wall_us:.4f} of the run), {n_events} device events")
    durs, per_kernel = device_ms_by_kernel(prof)
    top = sorted(durs.items(), key=lambda kv: -kv[1])[:15]
    print(f"{label}: device time by kernel (top 15, ms):"
          f" {json.dumps({k[:100]: round(v, 3) for k, v in top})}")
    print(f"{label}: device ms per run by wrapper {json.dumps(per_kernel)}")
    return per_kernel


# ---------------------------------------------------------------------------
# Phase 5: the affine lanes (BASELINE #1 and #4)


def read_png(path: str) -> np.ndarray:
    """(H, W, C) uint8 pixels of an 8-bit RGB or RGBA PNG, read by the
    port's reader (imageio.png: chunk CRCs checked, rows unfiltered), no
    Pillow."""
    from cybervision_tpu_torch.imageio import open_image

    mode, pixels, _ = open_image(path).decode()
    if mode not in ("RGB", "RGBA"):
        raise AssertionError(f"{path}: mode {mode}, not RGB or RGBA")
    return pixels


def phase_depth_map(img1, img2, disparity, ply_xyz, counters) -> dict:
    """BASELINE #1: the 1024x1024 pair to a PNG depth map with
    interpolation none, through reconstruct: a cold run, best of 3 warm
    runs, one profiled run. Gates on the PNG: over 30 % of the pixels
    opaque; the opaque pixels are exactly the vertices of phase 3's PLY
    (the same correlation), whose bounding box gives the crop offset; the
    depth read back through the nearest colour-table entry tracks the
    planted disparity, |r| >= 0.9."""
    from scipy.spatial import cKDTree

    from cybervision_tpu_torch.config import (
        InterpolationMode, ProjectionMode, ReconstructionConfig,
    )
    from cybervision_tpu_torch.images import SourceImage
    from cybervision_tpu_torch.output.colormap import _viridis_lut

    label = f"BASELINE #1 ({SIZE}x{SIZE} -> PNG depth map)"
    cfg = ReconstructionConfig(
        projection=ProjectionMode.AFFINE, interpolation=InterpolationMode.NONE
    )
    images = [SourceImage(im) for im in (img1, img2)]
    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "depth.png")
        cold_s, runs = reconstruct_runs(images, cfg, out, counters, 3)
        png_bytes = os.path.getsize(out)
        rgba = read_png(out)
    best_s, phases, launches = report_runs(label, "cold", cold_s, runs)
    device_ms = profile_end_to_end(img1, img2, label=f"profile of {label}", cfg=cfg,
                                   out_name="depth.png")

    opaque = rgba[:, :, 3] == 255
    share = float(opaque.sum()) / (SIZE * SIZE)
    vx = np.round(ply_xyz[:, 0]).astype(int)
    vy = np.round(-ply_xyz[:, 1]).astype(int)
    x0, y0 = int(vx.min()), int(vy.min())
    mask = np.zeros_like(opaque)
    if vx.max() - x0 < opaque.shape[1] and vy.max() - y0 < opaque.shape[0]:
        mask[vy - y0, vx - x0] = True
    same_pixels = bool(np.array_equal(mask, opaque))
    ys, xs = np.nonzero(opaque)
    k = cKDTree(_viridis_lut()).query(rgba[ys, xs, :3].astype(np.float64))[1]
    r = float(np.corrcoef(k, disparity[ys + y0, xs + x0])[0, 1])
    print(f"{label}: PNG {rgba.shape[1]}x{rgba.shape[0]} ({png_bytes} bytes) at offset"
          f" ({x0}, {y0}), {opaque.sum()} opaque pixels ({share:.4f} of the pair's),"
          f" equal to phase 3's PLY vertices {same_pixels}; colour-table index vs"
          f" planted disparity r {r:.4f}")
    if share <= 0.3:
        raise AssertionError(f"{label}: only {share:.3f} of the pixels are opaque")
    if not same_pixels:
        raise AssertionError(f"{label}: the opaque pixels are not the PLY's vertices")
    if abs(r) < 0.9:
        raise AssertionError(f"{label}: depth does not track the disparity (r {r:.3f})")
    return {"seconds": best_s, "launches": launches, "phases": phases,
            "device_ms": device_ms}


def read_obj(path: str):
    """(vertices (N, 3), vt count, face count) of an OBJ file."""
    with open(path, "rb") as fh:
        lines = fh.read().split(b"\n")
    verts = [ln[2:] for ln in lines if ln.startswith(b"v ")]
    n_vt = sum(1 for ln in lines if ln.startswith(b"vt "))
    n_f = sum(1 for ln in lines if ln.startswith(b"f "))
    xyz = np.array(b" ".join(verts).split(), dtype=np.float64).reshape(-1, 3)
    return xyz, n_vt, n_f


def phase_texture_obj(device, counters, gen) -> dict:
    """BASELINE #4: a 4032x3024 pair to a texture-coordinates OBJ with
    --max-points 500,000, through reconstruct. One warm-up run; then K1
    in both static forms at the full-resolution level's window on this
    pair's fields (bit-equal to the plain version), and K2 and K3 at the
    pair's match table, each timed; then best of 2 timed runs and one
    profiled run. Gates: the vertex count is min(500,000, valid pixels)
    of the dense result for the same F (one more correlate_images run),
    each vertex sits at a valid pixel with that result's exact depth,
    there are faces and one vt per track and image, both texture PNGs
    equal the images, and the depth tracks the planted disparity."""
    import torch

    from cybervision_tpu_torch.config import (
        MeshMode, ProjectionMode, ReconstructionConfig,
    )
    from cybervision_tpu_torch.images import SourceImage
    from cybervision_tpu_torch.ops import correlation
    from cybervision_tpu_torch.ops.epipolar import find_fundamental_matrix
    from cybervision_tpu_torch.utils.buckets import pow2_bucket

    label = f"BASELINE #4 ({LARGE_W}x{LARGE_H} -> texture OBJ, --max-points {MAX_POINTS})"
    t0 = time.perf_counter()
    img1, img2, disparity = synth_sem_pair(LARGE_H, LARGE_W)
    print(f"{label}: pair made in {time.perf_counter() - t0:.1f} s")
    aff = ProjectionMode.AFFINE
    cfg = ReconstructionConfig(
        projection=aff, mesh=MeshMode.TEXTURE_COORDINATES, max_points=MAX_POINTS
    )
    images = [SourceImage(im) for im in (img1, img2)]
    res = {}
    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "mesh.obj")
        warm_s, _ = reconstruct_runs(images, cfg, out, counters, 0)
        plan = dict(correlation._LAST_PLAN)
        window = max(plan["windows"][-1])
        print(f"{label}: warm-up {warm_s:.3f} s, correlation plan {plan}")

        t0 = time.perf_counter()
        for axis in ("horiz", "vert"):
            fields, kw = sweep_case(device, axis, LARGE_H, LARGE_W, window)
            r = check_sweep(fields, axis, kw, reps=3, label=f" at {LARGE_W}x{LARGE_H}")
            if not r["exact"]:
                raise AssertionError(f"K1 {axis} at {LARGE_W}x{LARGE_H}: not bit-equal to the plain version")
            res[f"K1 {axis}"] = {k: v for k, v in r.items() if k != "fields"}
            del fields, r
        torch.cuda.empty_cache()
        matches = main_path_matches(img1, img2, device)
        m = pow2_bucket(len(matches), floor=2048, factor=4)
        print(f"{label}: {len(matches)} matches, RANSAC table M = {m}")
        res["K2"] = check_score(matches, m, device, gen)
        res["K3"] = check_gather(matches, m, device, gen)
        print(f"{label}: kernel checks took {time.perf_counter() - t0:.1f} s")

        torch.cuda.reset_peak_memory_stats()
        _, runs = reconstruct_runs(images, cfg, out, counters, 2)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        xyz, n_vt, n_f = read_obj(out)
        with open(out, "rb") as fh:
            obj_sha = hashlib.sha256(fh.read()).hexdigest()
        tex = [read_png(os.path.join(td, f"mesh-{i}.png")) for i in range(2)]
    best_s, phases, launches = report_runs(label, "warm-up", warm_s, runs)
    print(f"{label}: peak device memory of the timed runs {peak_gib:.3f} GiB")
    device_ms = profile_end_to_end(img1, img2, label=f"profile of {label}", cfg=cfg,
                                   out_name="mesh.obj")
    draws = phase_word_sample(device)

    f = find_fundamental_matrix(matches, aff, float(LARGE_W), device=device, mesh=None).f
    word = correlation.correlate_images(
        *images, f, aff, cfg.correlation, device_out="word", device=device, mesh=None,
    ).cpu().numpy()
    valid = ((word >> 24) & 1) == 1
    n_valid = int(valid.sum())
    xs = np.round(xyz[:, 0]).astype(int)
    ys = np.round(-xyz[:, 1]).astype(int)
    at = word[ys, xs]
    exact = -np.hypot(xs - (at & 0xFFF), ys - ((at >> 12) & 0xFFF))
    on_valid = bool(valid[ys, xs].all())
    same_depth = bool(np.array_equal(xyz[:, 2], exact))
    distinct = len(np.unique(ys.astype(np.int64) * LARGE_W + xs)) == len(xyz)
    r = float(np.corrcoef(-xyz[:, 2], disparity[ys, xs])[0, 1])
    tex_ok = [t.shape == (LARGE_H, LARGE_W, 3) and np.array_equal(t, np.repeat(im[:, :, None], 3, 2))
              for t, im in zip(tex, (img1, img2))]
    print(f"{label}: OBJ {len(xyz)} vertices of {n_valid} valid pixels ({n_valid / (LARGE_H * LARGE_W):.4f}"
          f" of the pair), {n_vt} vt, {n_f} faces; vertices at distinct valid pixels"
          f" {on_valid and distinct}, depths equal to the dense result {same_depth};"
          f" depth vs planted disparity r {r:.4f}; textures equal to the images {tex_ok}")
    if len(xyz) != min(MAX_POINTS, n_valid) or not (on_valid and distinct and same_depth):
        raise AssertionError(f"{label}: the vertices are not a --max-points draw of the valid pixels")
    if n_f == 0 or n_vt != 2 * len(xyz):
        raise AssertionError(f"{label}: {n_f} faces, {n_vt} texture coordinates")
    if not all(tex_ok):
        raise AssertionError(f"{label}: a texture differs from its image")
    if r < 0.9:
        raise AssertionError(f"{label}: depth does not track the disparity (r {r:.3f})")
    return {"seconds": best_s, "launches": launches, "phases": phases,
            "device_ms": device_ms, "kernels": res, "m": m, "draws": draws,
            "peak_gib": peak_gib, "obj_sha256": obj_sha}


def phase_word_sample(device) -> dict:
    """The --max-points draw of BASELINE #4 on the card, by its parts:
    utils.prng.uniform over the 12.2 M pixels (float64, JAX's threefry)
    and the stable sort of the scores (CUDA events around 5 calls each,
    after a warm-up), and sample_word_grid whole on a word grid with 90 %
    of its pixels valid; the card's draw equals the CPU's."""
    import torch

    from cybervision_tpu_torch.ops.correlation import sample_word_grid
    from cybervision_tpu_torch.utils import prng

    n = LARGE_H * LARGE_W
    key = prng.prng_key(0)
    u = prng.uniform(key, (n,), device)
    # The draw of a flat index depends on the key and the index alone, so
    # a prefix is the draw of a shorter shape.
    m = min(n, 1 << 20)
    same = torch.equal(u[:m].cpu(), prng.uniform(key, (m,)))
    uniform_ms = cuda_ms(lambda: prng.uniform(key, (n,), device), 5)
    sort_ms = cuda_ms(lambda: torch.sort(-u, stable=True), 5)
    g = torch.Generator(device=device)
    g.manual_seed(1)
    word = torch.where(torch.rand((LARGE_H, LARGE_W), generator=g, device=device) < 0.9,
                       1 << 24, 0).to(torch.int32)
    sample_ms = cuda_ms(lambda: sample_word_grid(word, MAX_POINTS, 0), 5)
    print(f"--max-points draw over {n} pixels: uniform (float64 threefry) {uniform_ms:.3f} ms,"
          f" stable sort {sort_ms:.3f} ms, sample_word_grid whole {sample_ms:.3f} ms"
          f" (CUDA events, 5 calls); card's uniform equals the CPU's on the first {m}: {same}")
    if not same:
        raise AssertionError("the card's uniform draw differs from the CPU's")
    return {"uniform_ms": uniform_ms, "sort_ms": sort_ms, "sample_ms": sample_ms}


# ---------------------------------------------------------------------------
# Phase 6: the perspective path (BASELINE #3 and #5, and the full width)


def render_perspective(w: int, h: int, extra, seed: int = 3, exact_focal: bool = False):
    """tests/perspective_scene.render_views at w x h, K scaled with the
    image (400 px of focal length at 320x256): a texture on one world
    depth surface depth1(u, v) over camera 1's grid (camera 1 = identity
    pose), each extra view rendered by per-pixel fixed-point inversion of
    its rays onto that surface. `extra` holds the extra cameras as
    (axis-angle rotation, translation) pairs; with exact_focal the focal
    length is the one PERSP_FOCAL_35MM gives (407.3 px at 320x256, not
    400). Returns (views, depth1, k, cameras)."""
    from cybervision_tpu_torch.ops.surface import Camera

    f = PERSP_F * w / PERSP_W
    if exact_focal:
        f = PERSP_FOCAL_35MM * np.hypot(w, h) / np.hypot(24.0, 36.0)
    k = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
    cams = [Camera(k=k, r=np.array(r), t=np.array(t)) for r, t in extra]
    rng = np.random.RandomState(seed)
    tex = rng.uniform(0, 255, (h, w))
    tex = ndimage.gaussian_filter(tex, 1.0)
    bumps = ndimage.gaussian_filter(rng.uniform(0, 255, (h, w)), 6.0)
    img1 = tex * 0.55 + bumps * 0.45
    img1 = (img1 - img1.min()) / (img1.max() - img1.min()) * 255.0
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    depth1 = (
        8.0
        + 3.5 * np.sin(xs / w * 5.0)
        + 2.5 * (ys / h) ** 2
        + 1.5 * np.cos(ys / h * 7.0 + xs / w * 2.0)
    )
    k_inv = np.linalg.inv(k)

    def sample_depth1(u, v):
        return ndimage.map_coordinates(depth1, [v, u], order=1, mode="nearest")

    views = [np.round(img1).astype(np.uint8)]
    h_grid = np.stack([xs, ys, np.ones_like(xs)], axis=-1)
    for cam in cams:
        rays_c = h_grid @ k_inv.T
        r = cam.r_matrix
        d = np.full((h, w), float(depth1.mean()))
        for _ in range(12):
            pts_w = (rays_c * d[:, :, None] - cam.t[None, None, :]) @ r
            z1 = np.maximum(pts_w[:, :, 2], 1e-6)
            u1 = k[0, 0] * pts_w[:, :, 0] / z1 + k[0, 2]
            v1 = k[1, 1] * pts_w[:, :, 1] / z1 + k[1, 2]
            d = d * np.clip(sample_depth1(u1, v1) / z1, 0.5, 2.0)
        img_k = ndimage.map_coordinates(img1, [v1, u1], order=3, mode="nearest")
        views.append(np.round(np.clip(img_k, 0, 255)).astype(np.uint8))
    return views, depth1, k, cams


def _angle_deg(cos):
    return float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


def perspective_gates(label: str, rec, true_cams, depth1, out: str,
                      min_vertices: int, min_faces: int | None, pose_tol) -> dict:
    """The run's geometry against the renderer: every view recovered; each
    extra camera's rotation and translation direction within its
    pose_tol entry (degrees) of the renderer's after aligning camera 1 (the
    reconstruction's frame and scale are free); every point in front of
    the cameras that see it; depth seen from camera 1 tracking depth1 at
    the projected pixels (Pearson r >= DEPTH_R_MIN); the file's vertex
    (and face) counts above the JAX package's test floors."""
    surface = rec.surface
    cams = surface.cameras
    if len(cams) != len(true_cams) + 1:
        raise AssertionError(f"{label}: {len(cams)} cameras recovered of {len(true_cams) + 1}")
    r0, t0 = cams[0].r_matrix, cams[0].t
    rot_err, dir_err = [], []
    for cam, true in zip(cams[1:], true_cams):
        r_rel = cam.r_matrix @ r0.T
        t_rel = cam.t - r_rel @ t0
        rot_err.append(_angle_deg((np.trace(r_rel @ true.r_matrix.T) - 1.0) / 2.0))
        dir_err.append(_angle_deg(t_rel @ true.t / (np.linalg.norm(t_rel) * np.linalg.norm(true.t))))
    pts = surface.points3d
    behind = sum(int((~cam.point_in_front(pts[surface.track_visible(i)])).sum())
                 for i, cam in enumerate(cams))
    h, w = depth1.shape
    uv = surface.project_points(0)
    z = pts @ r0[2] + t0[2]
    inside = np.all(np.isfinite(uv), axis=1) & (uv[:, 0] >= 0) & (uv[:, 0] <= w - 1) \
        & (uv[:, 1] >= 0) & (uv[:, 1] <= h - 1)
    truth = depth1[np.round(uv[inside, 1]).astype(int), np.round(uv[inside, 0]).astype(int)]
    r_depth = float(np.corrcoef(z[inside], truth)[0, 1])
    n_v, n_f = read_mesh_counts(out)
    print(f"{label}: cameras rotation err {[round(x, 4) for x in rot_err]} deg, translation"
          f" direction err {[round(x, 4) for x in dir_err]} deg; {len(pts)} points,"
          f" {behind} behind a camera that sees them; depth vs the renderer r {r_depth:.4f}"
          f" ({int(inside.sum())} points in camera 1's image); file: {n_v} vertices, {n_f} faces")
    if any(r > tol[0] or d > tol[1] for r, d, tol in zip(rot_err, dir_err, pose_tol)):
        raise AssertionError(f"{label}: camera poses off the renderer's beyond {pose_tol} deg")
    if behind:
        raise AssertionError(f"{label}: {behind} points behind a camera that sees them")
    if not (r_depth >= DEPTH_R_MIN):
        raise AssertionError(f"{label}: depth does not track the renderer's (r {r_depth:.3f})")
    if n_v <= min_vertices or (min_faces is not None and n_f <= min_faces):
        raise AssertionError(f"{label}: {n_v} vertices / {n_f} faces, floors {min_vertices} / {min_faces}")
    return {"rot_err_deg": rot_err, "dir_err_deg": dir_err,
            "depth_r": r_depth, "vertices": n_v, "faces": n_f}


def read_mesh_counts(path: str) -> tuple[int, int]:
    """(vertices, faces) of a PLY (header counts) or an OBJ (v / f lines)."""
    if path.endswith(".ply"):
        with open(path, "rb") as fh:
            head = fh.read(4096).partition(b"end_header\n")[0].decode()
        n_v = int(head.split("element vertex ")[1].split("\n")[0])
        n_f = int(head.split("element face ")[1].split("\n")[0])
        return n_v, n_f
    n_v = n_f = 0
    with open(path) as fh:
        for line in fh:
            n_v += line.startswith("v ")
            n_f += line.startswith("f ")
    return n_v, n_f


def _group_phases(phases: dict) -> dict:
    """A run's phase seconds in the perspective path's groups."""
    def s(*keys):
        return round(sum(v for k, v in phases.items() if any(k.startswith(p) for p in keys)), 4)

    return {
        "matching": s("Extracted feature points", "Matched keypoints"),
        "ransac": s("Completed RANSAC fitting"),
        "pose_recovery": s("Recovered camera poses"),
        "dense": s("Completed dense correlation", "Fetched correlation grid", "Added dense image pair"),
        "track_merge": s("Merged tracks for"),
        "dlt": s("Finalize DLT"),
        "outlier_filter": s("Finalize outlier filter"),
        "bundle_adjustment": s("Finalize bundle adjustment"),
        "save": s("Saved result"),
        "total": s("Completed reconstruction"),
    }


class _Capture:
    """Records, during one run, the per-pair RANSAC inputs and results,
    the inputs of the largest K1 call (cloned: the finest level's) and
    the smallest
    and largest DLT triangulation's inputs, passing every call through."""

    def __init__(self):
        from cybervision_tpu_torch.ops import correlation, epipolar, sfm

        self.mods = (correlation, epipolar, sfm)
        self.pairs = None
        self.results = None
        self.sweep = None
        self.dlt = []

    def __enter__(self):
        correlation, epipolar, sfm = self.mods
        self.orig = (correlation.ncc_sweep, epipolar.find_fundamental_matrix_multi,
                     sfm.triangulate_tracks_np)
        sweep, multi, dlt = self.orig

        def sweep_rec(*args, **kw):
            if self.sweep is None or args[5].numel() > self.sweep[0][5].numel():
                self.sweep = ([a.clone() for a in args], dict(kw))
            return sweep(*args, **kw)

        def multi_rec(matches_list, projection, max_dims, *a, **kw):
            self.pairs = (list(matches_list), list(max_dims))
            self.results = multi(matches_list, projection, max_dims, *a, **kw)
            return self.results

        def dlt_rec(pts, projections, *a, **kw):
            self.dlt.append((pts.copy(), list(projections)))
            self.dlt = [min(self.dlt, key=lambda c: len(c[0])),
                        max(self.dlt, key=lambda c: len(c[0]))]
            return dlt(pts, projections, *a, **kw)

        correlation.ncc_sweep = sweep_rec
        epipolar.find_fundamental_matrix_multi = multi_rec
        sfm.triangulate_tracks_np = dlt_rec
        return self

    def __exit__(self, *exc):
        correlation, epipolar, sfm = self.mods
        (correlation.ncc_sweep, epipolar.find_fundamental_matrix_multi,
         sfm.triangulate_tracks_np) = self.orig
        return False


def perspective_runs(label: str, views, cfg, out: str, counters, warm: int,
                     exif: bool):
    """One warm-up run, `warm` timed runs (launch counts set to 0 just
    before each, read just after, and equal to the warm-up's; peak device
    memory over the timed runs), and one
    profiled run (the card's busy share, each wrapper's device ms). The
    images ride in memory; with `exif` their 35 mm focal length is set
    as the EXIF tag would (the card's machine has no Pillow)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cybervision_tpu_torch.images import SourceImage
    from cybervision_tpu_torch.reconstruction import Reconstruction

    images = [SourceImage(v, focal_length_35mm=PERSP_FOCAL_35MM if exif else None)
              for v in views]
    names = [f"view{i}.png" for i in range(len(views))]

    def one():
        rec = Reconstruction(names, out, cfg, quiet=True, images=images)
        rec.run()
        torch.cuda.synchronize()
        return rec

    def counts():
        return {n: getattr(mod, attr) for n, (mod, attr) in counters.items()}

    cap = _Capture()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    t0 = time.perf_counter()
    with cap:
        one()
    warmup_s = time.perf_counter() - t0
    warmup_launches = counts()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(warm):
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        t0 = time.perf_counter()
        rec = one()
        dt = time.perf_counter() - t0
        runs.append((dt, rec, counts()))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one()
        wall_us = (time.perf_counter() - t0) * 1e6
    t_prof = time.perf_counter()
    busy, n_events = device_busy_us(prof)
    durs, dev_ms = device_ms_by_kernel(prof)
    dev_ms["ncc_sweep_pixel"] = sum(v for k, v in durs.items() if "sweep_pixel_tile_kernel" in k)
    top = sorted(durs.items(), key=lambda kv: -kv[1])[:8]
    print(f"{label}: device time by kernel (top 8, ms):"
          f" {json.dumps({k[:100]: round(v, 3) for k, v in top})};"
          f" profile read in {time.perf_counter() - t_prof:.1f} s")
    best_s, rec, launches = min(runs, key=lambda r: r[0])
    if any(r[2] != warmup_launches for r in runs):
        raise AssertionError(f"{label}: launch counts vary between runs: warm-up"
                             f" {warmup_launches}, timed {[r[2] for r in runs]}")
    print(f"{label}: warm-up {warmup_s:.3f} s, warm best of {warm} {best_s:.4f} s"
          f" (runs {[round(r[0], 4) for r in runs]}); peak device memory {peak_gib:.3f} GiB")
    print(f"{label}: phases of the best run {json.dumps(_group_phases(rec.phases))}")
    print(f"{label}: launches per run {launches} (K1 per-pixel form"
          f" {launches['ncc_sweep_pixel']}, static forms"
          f" {launches['ncc_sweep'] - launches['ncc_sweep_pixel']})")
    print(f"{label}: profiled run wall {wall_us / 1e3:.3f} ms, device busy"
          f" {busy / 1e3:.3f} ms ({busy / wall_us:.4f} of the run), {n_events} device"
          f" events; device ms by wrapper {json.dumps({k: round(v, 4) for k, v in dev_ms.items()})}")
    print(f"{label}: ransac_failures {rec.ransac_failures}, dense_failures {rec.dense_failures}")
    return {"seconds": best_s, "rec": rec, "launches": launches, "peak_gib": peak_gib,
            "busy_share": busy / wall_us, "device_ms": dev_ms,
            "phases": _group_phases(rec.phases), "capture": cap}


def check_pair_failures(label: str, rec, n_views: int) -> None:
    """No pair fails, but for the 3-view scene's pair (views 2 and 3):
    the JAX package proves it unlinkable at the default acceptance floor
    (tests/test_pipeline_perspective.py::
    test_bench_dropped_pair_is_provably_unlinkable: the true F admits
    fewer than 200 of its matches), so its RANSAC may fail there; no
    dense correlation may fail."""
    allowed = 1 if n_views == 3 else 0
    if rec.ransac_failures > allowed or rec.dense_failures:
        raise AssertionError(
            f"{label}: {rec.ransac_failures} RANSAC / {rec.dense_failures} dense"
            f" failures (at most {allowed} / 0)")


def check_score_perspective(matches, max_dim: float, device, gen, reps=5) -> dict:
    """K2 at the perspective path's shape: 50,000 7-point samples of the
    pair's table solved as the main path solves them (Hartley in, up to
    three roots, F_px = T2^T F' T1), C = 150,000 candidates against the
    pair's bucketed table; counts equal, sums within rtol 1e-5."""
    import torch

    from cybervision_tpu_torch.config import ProjectionMode, RansacConfig
    from cybervision_tpu_torch.ops import score as k2
    from cybervision_tpu_torch.ops.epipolar import _hartley_np, solve_perspective_batch
    from cybervision_tpu_torch.utils.buckets import pow2_bucket

    rc = RansacConfig()
    t = rc.params(ProjectionMode.PERSPECTIVE)[2] * max_dim
    m_bucket = pow2_bucket(len(matches), floor=2048, factor=4)
    p1, p2, m_valid, _, top_limit = ransac_tables(matches, m_bucket, device)
    t1 = torch.as_tensor(_hartley_np(matches[:, 0:2]), dtype=torch.float32, device=device)
    t2 = torch.as_tensor(_hartley_np(matches[:, 2:4]), dtype=torch.float32, device=device)
    idx = torch.randint(0, top_limit, (BATCH, 7), generator=gen, device=device)
    n1 = torch.einsum("ij,bnj->bni", t1[:2, :2], p1[idx]) + t1[:2, 2]
    n2 = torch.einsum("ij,bnj->bni", t2[:2, :2], p2[idx]) + t2[:2, 2]
    f, valid = solve_perspective_batch(n1, n2, rc.rank_epsilon)
    f = torch.einsum("ji,brjk,kl->bril", t2, f, t1)
    f = f / torch.where(f[..., 2:, 2:].abs() > 1e-20, f[..., 2:, 2:], 1.0)
    ff = f.reshape(-1, 3, 3).contiguous()
    c = ff.shape[0]
    ck, sk = k2.score_candidates(ff, p1, p2, m_valid, t)
    cp, sp = k2.score_candidates_plain(ff, p1, p2, m_valid, t)
    torch.cuda.synchronize()
    label = f"K2 perspective C={c} M={m_bucket}"
    if not torch.equal(ck, cp):
        raise AssertionError(f"{label}: {int((ck != cp).sum())} counts differ")
    if not torch.allclose(sk, sp, rtol=SCORE_RTOL, atol=0.0):
        raise AssertionError(f"{label}: error sums beyond rtol {SCORE_RTOL}")
    err = float((sk - sp).abs().max())
    ms = cuda_ms(lambda: k2.score_candidates(ff, p1, p2, m_valid, t), reps)
    plain_ms = cuda_ms(lambda: k2.score_candidates_plain(ff, p1, p2, m_valid, t), 1,
                       warm_up=False)
    m_work = int(m_valid.sum())
    b_ms, b_by = bound_ms(c * 9 * 4 + m_bucket * (4 * 4 + 1) + c * 8, 36.0 * c * m_work)
    print(f"{label}: counts equal (max {int(ck.max())}, {int(valid.sum())} valid roots),"
          f" max|dsum| {err:.3g}; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms,"
          f" bound {b_ms:.4f} ms ({b_by}, {m_work} valid rows)")
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}


def check_gather_shape(matches, device, gen, n_samples: int) -> dict:
    """K3 at (13, n_samples, 50,000) draws from the pair's packed table:
    exact against its plain version and index_select; CUDA events around
    200 calls each."""
    import torch

    from cybervision_tpu_torch.ops import gather as k3
    from cybervision_tpu_torch.utils.buckets import pow2_bucket

    m_bucket = pow2_bucket(len(matches), floor=2048, factor=4)
    _, _, _, packed, top_limit = ransac_tables(matches, m_bucket, device)
    idx = torch.randint(0, top_limit, (DRAW_ROUNDS, n_samples, BATCH), generator=gen,
                        device=device, dtype=torch.int32)
    flat = idx.reshape(-1)
    out_k = k3.gather_packed(packed, idx)
    out_p = k3.gather_packed_plain(packed, idx)
    out_l = torch.index_select(packed, 1, flat).reshape(out_p.shape)
    torch.cuda.synchronize()
    if not (torch.equal(out_k, out_p) and torch.equal(out_l, out_p)):
        raise AssertionError(f"K3 {tuple(idx.shape)}: gathers differ")
    ms = cuda_ms(lambda: k3.gather_packed(packed, idx), 200)
    lib_ms = cuda_ms(lambda: torch.index_select(packed, 1, flat), 200)
    plain_ms = cuda_ms(lambda: k3.gather_packed_plain(packed, idx), 20)
    k = idx.numel()
    b_ms, b_by = bound_ms(4.0 * k + 4.0 * packed.numel() + 8.0 * k, 0.0)
    print(f"K3 {tuple(idx.shape)} M={m_bucket}: exact; kernel {ms:.4f} ms, plain"
          f" {plain_ms:.4f} ms, index_select {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"err": 0.0, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def check_dlt_paths(label: str, calls, device, reps: int = 5) -> list[dict]:
    """The DLT's smallest-eigenvector solve on the run's smallest and
    largest triangulation inputs: the host float64 eigh (the JAX
    package's path below 32,768 tracks) against
    sfm_device.dlt_nullspaces (float32 eigh on the card + float64 host
    polish), each timed whole, numpy in and out (best of 2 x `reps`, host
    clock). The dehomogenised points (|w| > 1e-3) must agree within
    DLT_AGREE_REL of the point's norm; the share within 1e-9 is printed."""
    from cybervision_tpu_torch.ops import sfm, sfm_device

    out = []
    for pts, projections in calls:
        ata, n_views = sfm.dlt_normals(pts, projections)
        a = ata[n_views >= 2]

        def host():
            return np.linalg.eigh(a)[1][:, :, 0]

        def card():
            return sfm_device.dlt_nullspaces(a, device)

        times = {}
        for name, fn in (("host", host), ("card", card), ("host", host), ("card", card)):
            for _ in range(reps):
                t0 = time.perf_counter()
                h = fn()
                times[name] = min(times.get(name, np.inf), time.perf_counter() - t0)
        h_host, h_card = host(), card()
        ok = (np.abs(h_host[:, 3]) > 1e-3) & (np.abs(h_card[:, 3]) > 1e-3)
        p_host = h_host[ok, :3] / h_host[ok, 3:]
        p_card = h_card[ok, :3] / h_card[ok, 3:]
        rel = float(np.max(np.linalg.norm(p_card - p_host, axis=1)
                           / np.maximum(np.linalg.norm(p_host, axis=1), 1e-12), initial=0.0))
        frac = float(np.mean(np.linalg.norm(p_card - p_host, axis=1)
                             <= 1e-9 * np.linalg.norm(p_host, axis=1))) if ok.any() else 1.0
        print(f"{label}: DLT of {len(a)} tracks ({len(projections)} cameras): host eigh"
              f" {times['host'] * 1e3:.3f} ms, card eigh + host polish"
              f" {times['card'] * 1e3:.3f} ms (best of {2 * reps}); points agree within"
              f" 1e-9 for {frac:.6f} (max rel {rel:.3g})")
        if not rel <= DLT_AGREE_REL:
            raise AssertionError(f"{label}: the DLT's two solves differ by {rel:.3g} relative")
        out.append({"tracks": len(a), "host_ms": times["host"] * 1e3,
                    "card_ms": times["card"] * 1e3, "max_rel": rel, "frac_1e9": frac})
    return out


def phase_perspective(device, counters, gen) -> dict:
    """BASELINE #3 (2 views of 320x256 -> OBJ, the EXIF focal length,
    bundle adjustment, default RANSAC budgets), BASELINE #5 (3 views ->
    merged PLY, --focal-length 43), the same 3-view scene at 1024x820
    (K x3.2) -> merged PLY, and the diagonal pair at 1024x820 -> OBJ,
    whose epipolar lines cross the image's diagonal (K1's per-pixel form
    on the main path); then K1's per-pixel form at the diagonal run's
    finest level, K2 and K3
    at the 3-view full-width run's largest pair, against their plain
    versions."""
    from cybervision_tpu_torch.config import (
        InterpolationMode, MeshMode, ProjectionMode, ReconstructionConfig,
    )

    counters = dict(counters, ncc_sweep_pixel=(counters["ncc_sweep"][0], "pixel_launches"))
    persp = dict(projection=ProjectionMode.PERSPECTIVE,
                 interpolation=InterpolationMode.DELAUNAY, mesh=MeshMode.VERTEX_COLORS)
    b5_tol = [(r + POSE_MARGIN_DEG, d + POSE_MARGIN_DEG) for r, d in POSE_REF_BASELINE5]
    out = {}
    with tempfile.TemporaryDirectory() as td:
        for key, label, extra, scale, ext, exif, warm, floors, pose_tol in (
            ("baseline3", "BASELINE #3 (2 views 320x256 -> OBJ)", PERSP_CAMS[:1], 1.0, "obj",
             True, 2, (2000, None), [POSE_TOL_DEG]),
            ("baseline5", "BASELINE #5 (3 views 320x256 -> merged PLY)", PERSP_CAMS, 1.0, "ply",
             False, 1, (2000, 1000), b5_tol),
            ("full_width", "full width (3 views 1024x820 -> merged PLY)", PERSP_CAMS, FULL_SCALE,
             "ply", False, 1, (2000, 1000), [POSE_TOL_DEG] * 2),
            ("diagonal", "full width diagonal (2 views 1024x820 -> OBJ, per-pixel axis)",
             (PERSP_CAM_DIAGONAL,), FULL_SCALE, "obj", False, 1, (2000, None), [POSE_TOL_DEG]),
        ):
            t0 = time.perf_counter()
            w, h = round(PERSP_W * scale), round(PERSP_H * scale)
            views, depth1, _, cams = render_perspective(w, h, extra)
            cfg = ReconstructionConfig(**persp, focal_length=None if exif else PERSP_FOCAL_35MM)
            path = os.path.join(td, f"persp_{key}.{ext}")
            r = perspective_runs(label, views, cfg, path, counters, warm, exif)
            check_pair_failures(label, r["rec"], len(views))
            r["gates"] = perspective_gates(label, r["rec"], cams, depth1, path, *floors, pose_tol)
            for name in ("ncc_sweep", "score_candidates", "gather_packed"):
                if r["launches"][name] == 0:
                    raise AssertionError(f"{label}: the path never launched {name}")
            if key == "diagonal" and r["launches"]["ncc_sweep_pixel"] == 0:
                raise AssertionError(f"{label}: K1's per-pixel form never launched")
            r["dlt"] = check_dlt_paths(label, r["capture"].dlt, device)
            r["scene"] = (views, depth1, cams)
            print(f"{label}: phase took {time.perf_counter() - t0:.1f} s")
            out[key] = r
    args, kw = out["diagonal"]["capture"].sweep
    fields = dict(zip(("img1", "vert", "center", "coeff", "add", "avg1", "isd1",
                       "start", "end", "p_ok", "w0"), args))
    sweep_kw = {k: kw[k] for k in ("threshold", "min_stdev", "window", "corridor_size", "h2", "w2")}
    print(f"K1 at the diagonal run's finest level: the run took the"
          f" {kw['axis'] or 'per-pixel'} form, window {kw['window']}")
    k1_pixel = check_sweep(fields, None, sweep_kw, reps=3, label=" full-width diagonal perspective")
    matches_list, max_dims = out["full_width"]["capture"].pairs
    pi = int(np.argmax([len(m) for m in matches_list]))
    k2_persp = check_score_perspective(matches_list[pi], max_dims[pi], device, gen)
    k3_persp = check_gather_shape(matches_list[pi], device, gen, 7)
    return {"runs": out, "k1_pixel": k1_pixel, "k2": k2_persp, "k3": k3_persp}


def phase_mesh_perspective(mesh, device, counters, persp) -> dict:
    """Phase 7: the perspective path under phase 4's mesh, through
    reconstruction.Reconstruction: BASELINE #5 (3 views of 320x256 ->
    merged PLY), whose third view's pose comes from P3P candidates
    scored on every shard, and phase 6's diagonal pair at 1024x820
    (-> OBJ), whose refine levels run K1s's per-pixel form on every
    shard. Each: a warm-up run, one timed run with its launches, one
    profiled run (busy share, device ms by wrapper), phase 6's gates,
    and the correlation plan (every level deep enough row-sharded).
    Then correlate_images of the diagonal pair for the F of phase 6's
    unsharded run, under the mesh and without it: equal bit for bit."""
    import torch

    from cybervision_tpu_torch.config import (
        CorrelationConfig, InterpolationMode, MeshMode, ProjectionMode,
        ReconstructionConfig,
    )
    from cybervision_tpu_torch.images import SourceImage
    from cybervision_tpu_torch.ops import correlation, ncc_sweep, sfm_device
    from cybervision_tpu_torch.parallel import use_mesh

    n = mesh.size
    counters = dict(
        counters, ncc_sweep_pixel=(ncc_sweep, "pixel_launches"),
        ncc_sweep_sharded=(ncc_sweep, "sharded_launches"),
        p3p_score=(sfm_device, "launches"), p3p_score_sharded=(sfm_device, "sharded_launches"),
    )
    persp_cfg = dict(projection=ProjectionMode.PERSPECTIVE,
                     interpolation=InterpolationMode.DELAUNAY, mesh=MeshMode.VERTEX_COLORS,
                     focal_length=PERSP_FOCAL_35MM)
    b5_tol = [(r + POSE_MARGIN_DEG, d + POSE_MARGIN_DEG) for r, d in POSE_REF_BASELINE5]
    out = {}
    with tempfile.TemporaryDirectory() as td, use_mesh(mesh):
        for key, label, ext, floors, pose_tol in (
            ("baseline5", f"BASELINE #5 under the mesh ({mesh.describe()})", "ply",
             (2000, 1000), b5_tol),
            ("diagonal", f"full width diagonal under the mesh ({mesh.describe()})", "obj",
             (2000, None), [POSE_TOL_DEG]),
        ):
            t0 = time.perf_counter()
            views, depth1, cams = persp["runs"][key]["scene"]
            path = os.path.join(td, f"mesh_{key}.{ext}")
            r = perspective_runs(label, views, ReconstructionConfig(**persp_cfg), path,
                                 counters, 1, False)
            plan = dict(correlation._LAST_PLAN)
            print(f"{label}: correlation plan of the last pair {plan}")
            check_pair_failures(label, r["rec"], len(views))
            r["gates"] = perspective_gates(label, r["rec"], cams, depth1, path, *floors, pose_tol)
            got = r["launches"]
            for name in ("ncc_sweep", "score_candidates", "gather_packed"):
                if got[name] == 0 or (name != "ncc_sweep" and got[name] % n):
                    raise AssertionError(f"{label}: {name} launched {got[name]} times over {n} shards")
            if key == "baseline5" and not got["p3p_score"] == n * got["p3p_score_sharded"] > 0:
                raise AssertionError(
                    f"{label}: P3P scored {got['p3p_score']} blocks in"
                    f" {got['p3p_score_sharded']} sharded calls over {n} shards")
            if key == "diagonal":
                if not (got["ncc_sweep_pixel"] == got["ncc_sweep"]
                        >= n * got["ncc_sweep_sharded"] > 0):
                    raise AssertionError(
                        f"{label}: K1s per-pixel launches {got['ncc_sweep_pixel']} of"
                        f" {got['ncc_sweep']}, {got['ncc_sweep_sharded']} sharded sweeps")
                check_sharded_plan(label, plan, views[0].shape, views[1].shape, mesh)
            r["plan"] = plan
            print(f"{label}: phase took {time.perf_counter() - t0:.1f} s")
            out[key] = r

    views = persp["runs"]["diagonal"]["scene"][0]
    f = persp["runs"]["diagonal"]["capture"].results[0].f
    src = [SourceImage(v) for v in views]
    cc = CorrelationConfig()
    proj = ProjectionMode.PERSPECTIVE
    single = correlation.correlate_images(*src, f, proj, cc, device_out=True, device=device,
                                          mesh=None)
    sharded = correlation.correlate_images(*src, f, proj, cc, device_out=True, device=device,
                                           mesh=mesh)
    plan = correlation._LAST_PLAN
    torch.cuda.synchronize()
    same = torch.equal(single, sharded)
    print(f"correlate_images of the diagonal pair under the mesh, F of phase 6's unsharded"
          f" run: planes equal {same} (valid share {float(single[:, :, 2].float().mean()):.4f},"
          f" plan {plan})")
    if not same:
        raise AssertionError("the sharded perspective correlation differs from the unsharded one")
    check_sharded_plan("diagonal correlate_images under the mesh", plan, views[0].shape,
                       views[1].shape, mesh)
    return out


# ---------------------------------------------------------------------------
# Phase 8: the CLI from files


ROOT = os.path.dirname(os.path.abspath(__file__))
SEM_DATABAR = 60
SEM_PIXEL_SIZE = 9.7656e-08
SEM_TILT = 0.1745329
SEM_TEXT = ("[Scan]\r\nPixelWidth={px}\r\nPixelHeight={px}\r\n[Stage]\r\nStageT={tilt}\r\n"
            "[PrivateFei]\r\nDatabarHeight={bar}\r\n")
PERSP_JPEGS = [os.path.join(ROOT, "tests", "fixtures", f"torch_persp_v{i}.jpg") for i in range(2)]
PERSP_DECODED = os.path.join(ROOT, "tests", "fixtures", "torch_persp_decoded.npz")
# Phase 8 (f): the pair of phase 6's scene at full width (1024x820, the
# 43 mm focal length) as progressive JPEGs and their baseline twins, and
# the SHA-256 of Pillow's planes of them and of Pillow's JPEG bytes for
# encoder_cases() (tests/gen_torch_formats_fixture.py writes all three).
PERSP_FULL_JPEGS = [os.path.join(ROOT, "tests", "fixtures", f"torch_persp_full_v{i}.jpg")
                    for i in range(2)]
PERSP_FULL_TWINS = [p[: -len(".jpg")] + "_baseline.jpg" for p in PERSP_FULL_JPEGS]
# Phase 8 (j): the full-width pair as lossy WebPs (VP8X: ALPH, VP8, EXIF)
# and BASELINE #3's views as lossless ones (VP8L, EXIF), written by
# tests/gen_torch_formats_fixture.py.
PERSP_FULL_WEBPS = [p[: -len(".jpg")] + ".webp" for p in PERSP_FULL_JPEGS]
PERSP_WEBPS_LOSSLESS = [os.path.join(ROOT, "tests", "fixtures", f"torch_persp_v{i}_lossless.webp")
                        for i in range(2)]
# Phase 8 (l): BASELINE #3's views (tint) as zstd-compressed RGB TIFFs
# with horizontal differencing, written by Pillow's libtiff through
# tests/gen_torch_formats_fixture.py (this script may use no zstd encoder).
LZMA_DAMAGED_TIFF = os.path.join(ROOT, "tests", "fixtures", "torch_lzma_damaged.tif")
PERSP_ZSTD_TIFFS = [os.path.join(ROOT, "tests", "fixtures", f"torch_persp_v{i}_zstd.tif")
                    for i in range(2)]
FORMATS_SHA256 = os.path.join(ROOT, "tests", "fixtures", "torch_formats_sha256.json")
# Phase 8 (r): JPEG 2000, written by Pillow 12.1 (OpenJPEG 2.5) through
# tests/gen_torch_formats_fixture.py: the full-width pair as RGB 9/7 JP2
# files (three quality layers, RPCL, 512x512 tiles from an odd tile
# offset; about 60 KB each), phase 3's SEM pair as gray 9/7 codestreams,
# BASELINE #3's views as lossless 5/3 RGB codestreams (LRCP, 64x64
# precincts) and one small file of each other kind (J2K_DECODE_ONLY).
J2K_DIR = os.path.join(ROOT, "tests", "fixtures", "jpeg2000")
J2K_FULL = [os.path.join(J2K_DIR, f"persp_full_97_v{i}.jp2") for i in range(2)]
J2K_SEM = [os.path.join(J2K_DIR, f"sem_97_{i}.j2k") for i in range(2)]
J2K_PERSP = [os.path.join(J2K_DIR, f"persp_53_v{i}.j2k") for i in range(2)]
J2K_DECODE_ONLY = ("la.jp2", "rgba.j2k", "cmyk.jp2", "cmyk.j2k", "ycbcr.jp2", "i16.j2k",
                   "signed.jp2", "pcrl.j2k", "cprl.jp2", "rlcp.j2k", "plt.j2k", "p.jp2", "pa.jp2",
                   "entry.icns")
AVIF_DIR = os.path.join(ROOT, "tests", "fixtures", "avif")
AVIF_SEM = [os.path.join(AVIF_DIR, f"sem_400_{i}.avif") for i in range(2)]
AVIF_PERSP = [os.path.join(AVIF_DIR, f"persp_420_v{i}.avif") for i in range(2)]
AVIF_DECODE_ONLY = ("rgba.avif", "yuv444.avif", "limited.avif", "lossless.avif", "tiled.avif",
                    "sequence.avif")
# Phase 8 (v3): the AVIF kinds libavif's encoder writes and Pillow's save
# does not, written through the wheel's libavif by
# tests/gen_torch_formats_fixture.py ("avif kinds"): phase 3's SEM pair as
# 2x2 grids of 512x512 tiles (4:2:0, matrix coefficients 1, full range,
# quantizer matrices, film grain test vector 1); one small file per
# matrix code Pillow reads (4:4:4 and 4:2:0, full and limited range),
# 2x3 colour and alpha grids (whole, and cropped by their ImageGrid),
# quantizer matrix and film grain files (AVIF_KINDS_DECODE_ONLY); and the
# files Pillow fails on, with the step that fails (AVIF_KINDS_FAIL).
AVIF_GRID_SEM = [os.path.join(AVIF_DIR, f"sem_grid_{i}.avif") for i in range(2)]
AVIF_MATRIX_READ = (0, 1, 2, 4, 5, 6, 7, 8, 9, 12, 15)
AVIF_KINDS_DECODE_ONLY = tuple(
    f"mc{mc}_{fmt}_{rng}.avif" for mc in AVIF_MATRIX_READ for fmt in ("444", "420")
    for rng in ("full", "limited") if not (mc == 0 and fmt == "420") and not (
        mc == 8 and rng == "limited")) + (
    "mc12p1_420_full.avif", "grid_2x3_alpha.avif", "grid_2x3_alpha_cropped.avif",
    "qm_420.avif", "qm_iq_444_low.avif", "qm_iq_444_high.avif", "grain_v1.avif",
    "grain_v2.avif", "grain_v10.avif", "grain_v16.avif", "grain_400.avif")
AVIF_KINDS_FAIL = {"mc3_420_full.avif": "load", "mc10_420_full.avif": "load",
                   "mc11_420_full.avif": "load", "mc13_420_full.avif": "load",
                   "mc14_420_full.avif": "load", "mc16_420_full.avif": "load",
                   "mc8_420_limited.avif": "load", "grid_missing_tile.avif": "open",
                   "grid_tile_size.avif": "load", "grid_not_covering.avif": "load"}
# Phase 8 (x): 10- and 12-bit AVIF and premultiplied alpha, written by
# tests/gen_torch_formats_fixture.py ("avif depth"): phase 3's SEM pair,
# AVIF_SEM's 4:0:0 files with every AV1 sequence header, av1C and pixi
# rewritten to 10 bits; BASELINE #3's views as RGBA 4:2:0 with a
# premultiplied alpha (a prem reference, alpha 200-255) and EXIF focal 43,
# rewritten to 12 bits (colour and alpha).
AVIF_DEPTH_SEM = [os.path.join(AVIF_DIR, f"sem_400_10bit_{i}.avif") for i in range(2)]
AVIF_DEPTH_PERSP = [os.path.join(AVIF_DIR, f"persp_420_12bit_prem_v{i}.avif") for i in range(2)]
# Phase 8 (y): superres AV1 key frames and frames scaled to their item's
# ispe, written by tests/gen_torch_formats_fixture.py ("avif scale"):
# phase 3's SEM pair at SIZE x SIZE, coded by the wheel's aom as 4:0:0 at
# the 910 columns superres denominator 9 gives and rewritten as superres
# files of SIZE columns (AVIF_SUPERRES_SEM); small superres files of each
# denominator end, subsampling and depth, with alpha, loop restoration
# and a grid, and files whose ispe asks libavif to scale the frame (the
# colour item, a shared colour and alpha ispe, a grid's tiles; up, down,
# one axis, the exact ratios, 8 and 12 bits) (AVIF_SCALE_DECODE_ONLY);
# the sizes libavif refuses to scale, with the step Pillow fails at
# (AVIF_SCALE_FAIL).
AVIF_SUPERRES_SEM = [os.path.join(AVIF_DIR, f"sem_400_superres_{i}.avif") for i in range(2)]
AVIF_SUPERRES_CODED = 910
AVIF_SCALE_DECODE_ONLY = (
    "superres_d9_420.avif", "superres_d12_444.avif", "superres_d16_400.avif",
    "superres_d13_420_10bit.avif", "superres_d11_444_12bit.avif", "superres_d10_rgba.avif",
    "superres_lr_420.avif", "superres_grid_alpha.avif", "scaled_up2_420.avif",
    "scaled_down2_420.avif", "scaled_up_420.avif", "scaled_height_444.avif",
    "scaled_box_444.avif", "scaled_down34_12bit.avif", "scaled_rgba_12bit.avif",
    "scaled_grid_tiles.avif")
AVIF_SCALE_FAIL = {"scaled_wide_refused.avif": "load"}
TIFF_TILE = 256  # phase 8 (g)'s tiled layout
JPEG_TIFF_ROWS = 64  # phase 8 (i)'s JPEG-in-TIFF rows per strip
# Phase 8 (e): the decoded .jpg depth map against the RGB it encodes:
# quality 75's error on a viridis map whose transparent (black) pixels
# make hard edges (29.3 dB on the 256x256 pair on the CPU).
JPEG_PSNR_MIN_DB = 25.0
LOW_POWER_WINDOW = 8  # CorrelationConfig.corridor_window_low_memory
# The child of a CLI subprocess: runs the package's __main__ as
# `python -m cybervision_tpu_torch` does (runpy.run_module), timing each
# file read (images._load: metadata and one decode) and reading the
# kernels' launch counts at exit, then prints them as one JSON line.
CLI_CHILD = r"""
import json, runpy, sys, time
t_start = time.perf_counter()
import cybervision_tpu_torch
from cybervision_tpu_torch import images
from cybervision_tpu_torch.ops import gather, ncc_sweep, score
decode = []
load = images._load
def timed(path, convert):
    t0 = time.perf_counter()
    out = load(path, convert)
    decode.append([path, convert.__name__, time.perf_counter() - t0])
    return out
images._load = timed
code = 0
try:
    runpy.run_module("cybervision_tpu_torch", run_name="__main__", alter_sys=True)
except SystemExit as done:
    code = done.code
print("CLI_RECORD " + json.dumps({
    "package": cybervision_tpu_torch.__file__, "child_seconds": time.perf_counter() - t_start,
    "decode": decode, "launches": {"ncc_sweep": ncc_sweep.launches,
    "score_candidates": score.launches, "gather_packed": gather.launches}}))
sys.exit(code)
"""


def split_jpeg_tables(data: bytes) -> tuple[bytes, bytes]:
    """(tables, stream) of a JPEG file, as libtiff stores a strip: its DQT
    and DHT segments between SOI and EOI (the JPEGTables tag), and the
    rest, an abbreviated stream."""
    table, stream, pos = b"\xff\xd8", b"\xff\xd8", 2
    while data[pos + 1] != 0xDA:  # the segments up to the scan
        n = struct.unpack_from(">H", data, pos + 2)[0]
        if data[pos + 1] in (0xDB, 0xC4):
            table += data[pos : pos + 2 + n]
        else:
            stream += data[pos : pos + 2 + n]
        pos += 2 + n
    return table + b"\xff\xd9", stream + data[pos:]


def jpeg_tiff_strips(rgb: np.ndarray) -> tuple[bytes, list[bytes]]:
    """(JPEGTables, strips) of a JPEG-compressed YCbCr TIFF of (H, W, 3)
    RGB: each JPEG_TIFF_ROWS-row strip coded by the port's baseline
    encoder (4:2:0, quality 75: Pillow's bytes), split_jpeg_tables'
    way."""
    from cybervision_tpu_torch.imageio.jpeg_encode import encode_jpeg

    tables, strips = b"", []
    for y in range(0, rgb.shape[0], JPEG_TIFF_ROWS):
        rows = np.ascontiguousarray(rgb[y : y + JPEG_TIFF_ROWS])
        tables, strip = split_jpeg_tables(encode_jpeg(rows))
        strips.append(strip)
    return tables, strips


def write_tiff(path: str, img: np.ndarray, sem_text: str | None, layout: str = "strip") -> None:
    """A TIFF of the image written without Pillow, with the FEI metadata
    block as tag 34683 (ASCII) unless `sem_text` is None, in one of six
    layouts: "strip" (one uncompressed little-endian strip of 8-bit gray:
    what an FEI SEM writes), "tiled" (TIFF_TILE x TIFF_TILE tiles, the
    edge tiles padded), "planar" (RGB of three equal planes,
    PlanarConfiguration 2: its L and RGB planes are the gray image's),
    "bigtiff" (one strip, BigTIFF's 8-byte offsets and 20-byte entries),
    "float" (ImageJ's 32-bit save: float32 `img`, big-endian, SampleFormat
    3, one strip), "jpeg" (RGB `img` as JPEG-compressed YCbCr 4:2:0 in
    strips, jpeg_tiff_strips), "cmyk" ((H, W, 4) `img` as one
    uncompressed strip of 8-bit CMYK, photometric 5) and "lzma" (one
    strip of 8-bit gray with horizontal differencing, predictor 2, as an
    xz stream: compression 34925, what libtiff-based writers save)."""
    h, w = img.shape[:2]
    big = layout == "bigtiff"
    endian = ">" if layout == "float" else "<"
    spp = {"planar": 3, "jpeg": 3, "cmyk": 4}.get(layout, 1)
    photometric = {3: 2, 4: 5}.get(spp, 1)
    bps, compression, rows_per_strip, extra = 8, 1, h, []
    if layout == "tiled":
        t = TIFF_TILE
        pad = np.zeros((-(-h // t) * t, -(-w // t) * t), np.uint8)
        pad[:h, :w] = img
        chunks = [pad[y : y + t, x : x + t].tobytes() for y in range(0, h, t) for x in range(0, w, t)]
    elif layout == "float":
        chunks, bps = [np.ascontiguousarray(img, ">f4").tobytes()], 32
        extra = [(339, 3, [3])]
    elif layout == "jpeg":
        tables, chunks = jpeg_tiff_strips(img)
        photometric, compression, rows_per_strip = 6, 7, JPEG_TIFF_ROWS
        extra = [(347, 7, tables), (530, 3, [2, 2])]
    elif layout == "lzma":
        import lzma

        diff = np.array(img, np.uint8)
        diff[:, 1:] = img[:, 1:] - img[:, :-1]  # each sample less its left neighbour, mod 256
        chunks, compression = [lzma.compress(diff.tobytes(), format=lzma.FORMAT_XZ)], 34925
        extra = [(317, 3, [2])]
    else:
        chunks = [np.ascontiguousarray(img).tobytes()] * (3 if layout == "planar" else 1)
    head = 16 if big else 8
    offsets = [int(o) for o in np.cumsum([head] + [len(c) for c in chunks[:-1]])]
    offset_type = 16 if big else 4  # LONG8 / LONG
    place = [(322, 3, [TIFF_TILE]), (323, 3, [TIFF_TILE]), (324, offset_type, offsets),
             (325, offset_type, [len(c) for c in chunks])] if layout == "tiled" else [
        (273, offset_type, offsets), (278, 4, [rows_per_strip]),
        (279, offset_type, [len(c) for c in chunks])]
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bps] * spp), (259, 3, [compression]),
            (262, 3, [photometric]), (277, 3, [spp])] + place + extra
    if sem_text is not None:
        tags.append((34683, 2, sem_text.encode() + b"\0"))
    if layout == "planar":
        tags.append((284, 3, [2]))
    tags.sort(key=lambda tag: tag[0])
    codes = {3: "H", 4: "L", 16: "Q"}
    slot = 8 if big else 4  # the bytes of a value held in its entry
    ifd_at = head + sum(len(c) for c in chunks)
    ifd_at += ifd_at % 2
    values_at = ifd_at + (8 if big else 2) + (20 if big else 12) * len(tags) + slot
    entries, values = b"", b""
    for tag, typ, vals in tags:
        raw = vals if isinstance(vals, bytes) else struct.pack(
            f"{endian}{len(vals)}{codes[typ]}", *vals)
        entries += struct.pack(endian + ("HHQ" if big else "HHL"), tag, typ, len(vals))
        if len(raw) <= slot:
            entries += raw.ljust(slot, b"\0")
        else:
            entries += struct.pack(endian + ("Q" if big else "L"), values_at + len(values))
            values += raw + b"\0" * (len(raw) % 2)
    with open(path, "wb") as fh:
        fh.write(b"II+\0" + struct.pack("<HHQ", 8, 0, ifd_at) if big
                 else (b"II*\0" if endian == "<" else b"MM\0*") + struct.pack(endian + "L", ifd_at))
        for c in chunks:
            fh.write(c)
        fh.write(b"\0" * (ifd_at - head - sum(len(c) for c in chunks)))
        fh.write(struct.pack(endian + ("Q" if big else "H"), len(tags)) + entries + b"\0" * slot
                 + values)


def _rle8_row(row: np.ndarray) -> bytes:
    """One row of RLE8 (without its end of line): runs of 4 or more equal
    pixels encoded, the rest in absolute runs of 3-254 pixels (padded to
    16-bit words), leftovers of 1-2 pixels as encoded runs of 1."""
    out = bytearray()
    change = np.flatnonzero(np.diff(row)) + 1
    starts = np.concatenate([[0], change])
    lens = np.diff(np.concatenate([starts, [len(row)]]))
    lit = 0  # where the pending literal pixels start
    for s, n in zip(starts[lens >= 4].tolist(), lens[lens >= 4].tolist()):
        out += _rle8_literal(row[lit:s])
        while n:
            k = min(n, 255)
            out += bytes([k, int(row[s])])
            n -= k
        lit = s + int(lens[np.searchsorted(starts, s)])
    out += _rle8_literal(row[lit:])
    return bytes(out)


def _rle8_literal(px: np.ndarray) -> bytes:
    out = bytearray()
    n, i = len(px), 0
    while n - i >= 3:
        k = min(n - i, 254)
        if n - i - k in (1, 2):
            k -= 3
        out += bytes([0, k]) + px[i : i + k].tobytes() + b"\0" * (k % 2)
        i += k
    for v in px[i:].tolist():
        out += bytes([1, v])
    return bytes(out)


def write_bmp(path: str, img: np.ndarray, rle: bool = False, dib: bool = False) -> None:
    """An 8-bit BMP of the gray image with a gray palette (entry i = (i,
    i, i): Pillow opens it as "L"), what JEOL and Hitachi SEMs save: the
    40-byte header, rows bottom-up, uncompressed or RLE8 (_rle8_row, an
    end of line after each row, the end of bitmap after the last); with
    `dib`, without the 14-byte file header (a headerless DIB, the pixels
    right after the palette)."""
    h, w = img.shape
    rows = np.ascontiguousarray(img[::-1])
    if rle:
        data = b"\0\0".join(_rle8_row(r) for r in rows) + b"\0\1"
    else:
        stride = (w + 3) & ~3
        pad = np.zeros((h, stride), np.uint8)
        pad[:, :w] = rows
        data = pad.tobytes()
    palette = np.repeat(np.arange(256, dtype=np.uint8), 4)
    palette[3::4] = 0
    offset = 14 + 40 + 1024
    with open(path, "wb") as fh:
        if not dib:
            fh.write(b"BM" + struct.pack("<IHHI", offset + len(data), 0, 0, offset))
        fh.write(struct.pack("<IiiHHIIiiII", 40, w, h, 1, 8, 1 if rle else 0, len(data), 3780, 3780,
                             256, 0))
        fh.write(palette.tobytes() + data)


def gif_lzw(indices: np.ndarray, min_size: int, deferred_clear: bool = False) -> bytes:
    """A GIF frame's image data after its minimum code size byte: the
    indices (all below 2^min_size) LZW-coded with codes LSB first, a clear
    code first, the code width growing once code 2^k is defined, up to 12
    bits; when the table is full a clear code restarts it, or, with
    `deferred_clear`, the full table stays in use. In sub-blocks of 255
    bytes, then the end code and the block terminator."""
    clear = 1 << min_size
    width, nxt, table = min_size + 1, clear + 2, {}
    codes, widths = [clear], [width]
    data = indices.ravel().tolist()
    w = data[0]
    for c in data[1:]:
        key = (w << 12) | c
        hit = table.get(key)
        if hit is not None:
            w = hit
            continue
        codes.append(w)
        widths.append(width)
        if nxt < 4096:
            table[key] = nxt
            nxt += 1
            if nxt - 1 == 1 << width and width < 12:
                width += 1
        elif not deferred_clear:
            codes.append(clear)
            widths.append(width)
            width, nxt, table = min_size + 1, clear + 2, {}
        w = c
    codes += [w, clear + 1]
    widths += [width, width]
    out, acc, bits = bytearray(), 0, 0
    for code, n in zip(codes, widths):
        acc |= code << bits
        bits += n
        while bits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            bits -= 8
    if bits:
        out.append(acc)
    blocks = b"".join(bytes([len(out[i : i + 255])]) + out[i : i + 255]
                      for i in range(0, len(out), 255))
    return blocks + b"\0"


def interlaced_rows(h: int) -> np.ndarray:
    """A GIF's interlaced row order: every 8th row from 0, from 4, every
    4th from 2, every 2nd from 1."""
    return np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4),
                           np.arange(1, h, 2)])


def write_gif(path: str, img: np.ndarray, interlace: bool = False) -> None:
    """A GIF89a of the gray image: a global table of the 256 grays (entry
    i = (i, i, i): Pillow opens it as "L"), one frame, its rows LZW-coded
    (gif_lzw), in the interlaced pass order when asked."""
    h, w = img.shape
    rows = img[interlaced_rows(h)] if interlace else img
    table = np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes()
    with open(path, "wb") as fh:
        fh.write(b"GIF89a" + struct.pack("<HHBBB", w, h, 0xF7, 0, 0) + table)
        fh.write(b"," + struct.pack("<HHHHB", 0, 0, w, h, 0x40 if interlace else 0) + b"\x08")
        fh.write(gif_lzw(rows, 8) + b";")


def encoder_cases() -> list[tuple[str, np.ndarray]]:
    """The JPEG encoder's seeded arrays, whose Pillow bytes' SHA-256 are
    committed (FORMATS_SHA256): at nine sizes from 1x1 to 256x200 — single
    rows and columns, odd sizes, sizes on and off the 16-pixel MCU grid —
    a flat colour, ramps, colour noise and gray noise."""
    cases = []
    for i, (h, w) in enumerate(((1, 1), (1, 61), (45, 1), (15, 17), (16, 16), (31, 33),
                                (64, 48), (97, 130), (256, 200))):
        rng = np.random.RandomState(700 + i)
        ys, xs = np.mgrid[0:h, 0:w]
        ramp = np.stack([xs * 255 // max(w - 1, 1), ys * 255 // max(h - 1, 1), (xs + 3 * ys) % 256],
                        axis=-1).astype(np.uint8)
        noise = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        cases += [(f"flat {h}x{w}", np.full((h, w, 3), rng.randint(0, 256, 3), np.uint8)),
                  (f"ramp {h}x{w}", ramp), (f"noise {h}x{w}", noise),
                  (f"gray noise {h}x{w}", np.ascontiguousarray(noise[:, :, 0]))]
    return cases


def sem_tiff_pair(td: str, img1, img2, layout: str = "strip") -> list[str]:
    """The pair as FEI SEM TIFFs in write_tiff's `layout`, with a
    SEM_DATABAR-row databar of seeded junk appended below each image."""
    rng = np.random.RandomState(60)
    paths = []
    for k, img in enumerate((img1, img2)):
        bar = rng.randint(0, 256, (SEM_DATABAR, img.shape[1])).astype(np.uint8)
        paths.append(os.path.join(td, f"sem_{layout}_{k}.tif"))
        write_tiff(paths[-1], np.concatenate([img, bar]), SEM_TEXT.format(
            px=SEM_PIXEL_SIZE, tilt=SEM_TILT, bar=SEM_DATABAR), layout)
    return paths


def _sha(path: str) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def _decode_record(decode) -> dict:
    """{file name: {to_l / to_rgb: seconds}} of the timed file reads."""
    rec: dict = {}
    for path, kind, secs in decode:
        rec.setdefault(os.path.basename(path), {})[kind] = round(secs, 4)
    return rec


def cli_record(run: str, seconds: float, phases: dict, decode, launches: dict, smi: str,
               encode=(), **extra) -> dict:
    rec = {"phase8": run, "seconds": round(seconds, 4),
           "phases": {k: round(v, 4) for k, v in phases.items()},
           "decode_s": _decode_record(decode),
           "encode_s": {os.path.basename(p): round(secs, 4) for p, secs in encode},
           **extra, "launches": launches, "card": smi}
    print(json.dumps(rec))
    for name in ("ncc_sweep", "score_candidates", "gather_packed"):
        if launches.get(name, 0) == 0:
            raise AssertionError(f"phase 8 {run}: the run never launched {name}")
    return rec


class _CliCapture:
    """In-process cli.main runs: each run's Reconstruction (its phases and
    surface), the file reads and the depth-map encodes (encode and write)
    timed, the launch counts set to 0 before a run, the standard output
    kept."""

    def __init__(self, counters):
        self.counters = counters

    def main(self, argv: list[str]) -> dict:
        import torch

        from cybervision_tpu_torch import cli, images
        from cybervision_tpu_torch.output import writers
        from cybervision_tpu_torch.reconstruction import Reconstruction

        recs, decode, encode = [], [], []
        run, load, save = Reconstruction.run, images._load, writers._save_image

        def run_rec(rec):
            recs.append(rec)
            return run(rec)

        def load_timed(path, convert):
            t0 = time.perf_counter()
            out = load(path, convert)
            decode.append((path, convert.__name__, time.perf_counter() - t0))
            return out

        def save_timed(path, rgba):
            t0 = time.perf_counter()
            save(path, rgba)
            encode.append((path, time.perf_counter() - t0))

        for mod, attr in self.counters.values():
            setattr(mod, attr, 0)
        Reconstruction.run, images._load, writers._save_image = run_rec, load_timed, save_timed
        stdout = io.StringIO()
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(stdout):
                code = cli.main(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            Reconstruction.run, images._load, writers._save_image = run, load, save
        if code != 0:
            raise AssertionError(f"phase 8: cli.main({argv}) returned {code}:\n{stdout.getvalue()}")
        return {"seconds": seconds, "rec": recs[-1], "decode": decode, "encode": encode,
                "stdout": stdout.getvalue(),
                "launches": {n: getattr(m, a) for n, (m, a) in self.counters.items()}}


def cli_subprocess(cwd: str, argv: list[str], label: str) -> dict:
    """One `python -m cybervision_tpu_torch` run in a fresh interpreter
    from `cwd` (CLI_CHILD); fails on a nonzero exit."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", CLI_CHILD, *argv], cwd=cwd,
                          capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    records = [ln for ln in lines if ln.startswith("CLI_RECORD ")]
    if proc.returncode != 0 or not records:
        raise AssertionError(f"{label}: exit {proc.returncode}\n{proc.stdout[-4000:]}\n"
                             f"{proc.stderr[-4000:]}")
    rec = json.loads(records[-1][len("CLI_RECORD "):])
    phases = {}
    for ln in lines:  # the CLI's "<phase> in N seconds" lines
        phrase, _, secs = ln.rpartition(" in ")
        if phrase and secs.endswith(" seconds"):
            phases[phrase] = phases.get(phrase, 0.0) + float(secs.split()[0])
    rec.update(seconds=seconds, phases=phases)
    return rec


def package_copy(td: str) -> str:
    """A copy of the package without its builds (_build/, native/*.so and
    the objects native/*.o): a run from it builds both libraries from the
    sources."""
    dst = os.path.join(td, "cybervision_tpu_torch")
    shutil.copytree(os.path.join(ROOT, "cybervision_tpu_torch"), dst,
                    ignore=shutil.ignore_patterns("_build", "*.so", "*.o", ".build.lock",
                                                  "__pycache__"))
    return td


class _WindowLog:
    """The sweep windows of every pyramid level step and the fixed window
    of every correlate_images call, in order, during a `with` block."""

    def __init__(self):
        from cybervision_tpu_torch.ops import correlation

        self.mod = correlation
        self.fixed, self.events = [], []

    def __enter__(self):
        corr = self.mod
        self.orig = (corr.correlate_images, corr._level_step)
        images_fn, step_fn = self.orig

        def images(src1, src2, f, projection, cfg, *a, **kw):
            self.fixed.append(cfg.corridor_window_fixed)
            self.events.append("call")
            return images_fn(src1, src2, f, projection, cfg, *a, **kw)

        def step(pair, state_f, state_r, lv, params, win_f, win_r, *a, **kw):
            self.events.append((win_f, win_r))
            return step_fn(pair, state_f, state_r, lv, params, win_f, win_r, *a, **kw)

        corr.correlate_images, corr._level_step = images, step
        return self

    def __exit__(self, *exc):
        self.mod.correlate_images, self.mod._level_step = self.orig
        return False

    def clamp(self, window: int) -> tuple[bool, list, bool]:
        """Whether the first correlate_images call ran its fixed pass at
        `window`: (clamped, the pass's coarse level windows, escalated).
        The finest level of a fixed pass widens to the bucket of its
        reach, and a coarse reach beyond the window escalates to a
        data-driven rerun (ops/correlation.py; the reference's
        semantics), so only the coarse levels are held to it."""
        if not self.events or self.events[0] != "call":
            return False, [], False
        rest = self.events[1:]
        first_pass = rest[: rest.index("call")] if "call" in rest else rest
        escalated = "call" in rest
        coarse = first_pass if escalated else first_pass[:-1]
        clamped = (self.fixed[0] == window and bool(coarse)
                   and all(w == (window, window) for w in coarse))
        return clamped, coarse, escalated


def copy_builds(copy: str) -> list[str]:
    """The libraries built inside a package copy: the native host library
    and the CUDA kernels' library."""
    pkg = os.path.join(copy, "cybervision_tpu_torch")
    found = [os.path.join(pkg, "native", "libcvtorch_native.so")]
    found += [os.path.join(pkg, "_build", f) for f in
              (os.listdir(os.path.join(pkg, "_build")) if os.path.isdir(os.path.join(pkg, "_build"))
               else []) if f.startswith("libcvtorch_kernels_") and f.endswith(".so")]
    return [p for p in found if os.path.exists(p)]


def ply_depth_r(xyz: np.ndarray, disparity: np.ndarray) -> float:
    h, w = disparity.shape
    xs = np.clip(np.round(xyz[:, 0]).astype(int), 0, w - 1)
    ys = np.clip(np.round(-xyz[:, 1]).astype(int), 0, h - 1)
    return float(np.corrcoef(-xyz[:, 2], disparity[ys, xs])[0, 1])


def phase_cli_files(counters, smi: str, texture_obj_sha: str) -> dict:
    """Phase 8: the CLI from files on the card (module docstring)."""
    import torch

    from cybervision_tpu_torch.config import (
        HardwareMode, InterpolationMode, MeshMode, ProjectionMode, ReconstructionConfig,
    )
    from cybervision_tpu_torch.images import SourceImage
    from cybervision_tpu_torch.ops import correlation
    from cybervision_tpu_torch.imageio.png_encode import encode_png
    from cybervision_tpu_torch.output.colormap import map_depth
    from cybervision_tpu_torch.reconstruction import reconstruct

    cap = _CliCapture(counters)
    records = {}
    img1, img2, disparity = synth_sem_pair(SIZE, SIZE)
    mem = [SourceImage(im, scale=(SEM_PIXEL_SIZE, SEM_PIXEL_SIZE), tilt_angle=SEM_TILT)
           for im in (img1, img2)]
    aff = ProjectionMode.AFFINE
    with tempfile.TemporaryDirectory() as td:
        tifs = sem_tiff_pair(td, img1, img2)
        # (a) the SEM TIFF pair -> PLY, --mode=gpu: in memory first, then
        # cold and warm subprocesses and cli.main best of 3.
        label = f"(a) SEM TIFF pair {SIZE}x{SIZE}+{SEM_DATABAR} -> PLY"
        ref_ply = os.path.join(td, "mem.ply")
        reconstruct(["a", "b"], ref_ply, ReconstructionConfig(
            projection=aff, mesh=MeshMode.VERTEX_COLORS), quiet=True, images=mem)
        ref_sha = _sha(ref_ply)
        argv = ["--projection=parallel", "--mesh=vertex-colors"]
        copy = package_copy(os.path.join(td, "copy"))
        if copy_builds(copy):
            raise AssertionError(f"{label}: the package copy holds a build")
        for run in ("cold", "warm process"):
            out = os.path.join(td, f"{run.split()[0]}.ply")
            rec = cli_subprocess(copy, [*argv, *tifs, out], f"{label} {run}")
            if not rec["package"].startswith(os.path.join(copy, "cybervision_tpu_torch")):
                raise AssertionError(f"{label} {run}: imported {rec['package']}, not the copy")
            if len(copy_builds(copy)) != 2:
                raise AssertionError(f"{label} {run}: the copy did not build both libraries")
            if _sha(out) != ref_sha:
                raise AssertionError(f"{label} {run}: the PLY differs from the in-memory run's")
            records[run] = cli_record(f"(a) {run}", rec["seconds"], rec["phases"], rec["decode"],
                                      rec["launches"], smi)
            print(f"{label}: {run} run {rec['seconds']:.3f} s (child {rec['child_seconds']:.3f} s"
                  f" from its first line, package {rec['package']})")
        runs = []
        for _ in range(3):
            out = os.path.join(td, "inproc.ply")
            runs.append(cap.main(["--mode=gpu", *argv, *tifs, out]))
            if _sha(out) != ref_sha:
                raise AssertionError(f"{label} in-process: the PLY differs from the in-memory run's")
        best = min(runs, key=lambda r: r["seconds"])
        records["in-process"] = cli_record(
            "(a) in-process, best of 3", best["seconds"], best["rec"].phases, best["decode"],
            best["launches"], smi)
        r = ply_depth_r(read_ply_vertices(out), disparity)
        print(f"{label}: in-process runs {[round(x['seconds'], 4) for x in runs]} s; PLY equal to"
              f" the in-memory run's in every run; depth vs planted disparity r {r:.4f}")
        if r < 0.9:
            raise AssertionError(f"{label}: depth does not track the disparity (r {r:.3f})")

        # (b) the same TIFFs -> PNG depth map, --mode=gpu-low-power.
        label = "(b) SEM TIFF pair -> PNG depth map, gpu-low-power"
        ref_png = os.path.join(td, "mem.png")
        reconstruct(["a", "b"], ref_png, ReconstructionConfig(
            projection=aff, interpolation=InterpolationMode.NONE,
            hardware=HardwareMode.GPU_LOW_POWER), quiet=True, images=mem)
        out = os.path.join(td, "low.png")
        with _WindowLog() as log:
            low = cap.main(["--mode=gpu-low-power", "--projection=parallel",
                            "--interpolation=none", *tifs, out])
        records["low-power"] = cli_record("(b) gpu-low-power", low["seconds"], low["rec"].phases,
                                          low["decode"], low["launches"], smi)
        said = "low-power" in low["stdout"]
        clamped, coarse, escalated = log.clamp(LOW_POWER_WINDOW)
        print(f"{label}: PNG equal to the in-memory run's {_sha(out) == _sha(ref_png)};"
              f" printed low-power {said}; fixed windows per correlate_images call"
              f" {log.fixed}; the fixed pass's coarse levels {coarse}; escalated to data-driven"
              f" windows {escalated}; windows of the pass kept"
              f" {[w for w in correlation._LAST_PLAN['windows'] if w is not None]}")
        if _sha(out) != _sha(ref_png):
            raise AssertionError(f"{label}: the PNG differs from the in-memory run's")
        if not said or not clamped:
            raise AssertionError(f"{label}: not the low-power window clamp")

        # (c) the EXIF JPEG pair -> OBJ, --mode=gpu, no --focal-length.
        ref = np.load(PERSP_DECODED)
        srcs = [SourceImage.load(p) for p in PERSP_JPEGS]
        planes_ok = all(np.array_equal(s.img, ref[f"v{i}_l"])
                        and np.array_equal(s.load_rgb_plane(), ref[f"v{i}_rgb"])
                        for i, s in enumerate(srcs))
        records["exif jpeg"] = cli_exif_jpeg_pair(
            cap, smi, td, "(c) EXIF JPEG pair", f"(c) EXIF JPEG pair {PERSP_W}x{PERSP_H} -> OBJ",
            PERSP_JPEGS, srcs, {"decoded planes equal to Pillow's": planes_ok},
            (PERSP_W, PERSP_H))

        # (d) BASELINE #4 from PNG files.
        label = f"(d) BASELINE #4 from PNG files ({LARGE_W}x{LARGE_H})"
        big1, big2, _ = synth_sem_pair(LARGE_H, LARGE_W)
        pngs = []
        t0 = time.perf_counter()
        for k, im in enumerate((big1, big2)):
            pngs.append(os.path.join(td, f"large_{k}.png"))
            with open(pngs[-1], "wb") as fh:
                fh.write(encode_png(np.repeat(im[:, :, None], 3, axis=2)))
        print(f"{label}: inputs written in {time.perf_counter() - t0:.1f} s"
              f" ({[os.path.getsize(p) for p in pngs]} bytes)")
        # (e)'s encode timings: viridis maps of the SEM images.
        timed_rgb = {f"{SIZE}x{SIZE}": map_depth(img1 / 255.0),
                     f"{LARGE_W}x{LARGE_H}": map_depth(big1 / 255.0)}
        texture = np.repeat(big1[:, :, None], 3, axis=2)  # (s)'s texture encode
        del big1, big2
        tex_dir = os.path.join(td, "tex")
        os.makedirs(tex_dir)
        out = os.path.join(tex_dir, "mesh.obj")
        large = cap.main(["--projection=parallel", "--mesh=texture-coordinates",
                          f"--max-points={MAX_POINTS}", *pngs, out])
        records["baseline4 png"] = cli_record("(d) BASELINE #4 from PNG files", large["seconds"],
                                              large["rec"].phases, large["decode"],
                                              large["launches"], smi)
        copies = [_sha(os.path.join(tex_dir, f"mesh-{k}.png")) == _sha(p)
                  for k, p in enumerate(pngs)]
        same = _sha(out) == texture_obj_sha
        print(f"{label}: textures verbatim copies of the inputs {copies}; OBJ equal to phase 5's"
              f" in-memory run {same}")
        if not all(copies) or not same:
            raise AssertionError(f"{label}: textures or OBJ differ")

        records.update(cli_jpeg_depth_map(cap, smi, td, tifs, timed_rgb))
        records.update(cli_progressive_pair(cap, smi, td))
        records.update(cli_tiff_layouts(cap, smi, td, img1, img2, ref_sha))
        records.update(cli_instrument_files(cap, smi, td, img1, img2))
        records.update(cli_gif_webp(cap, smi, td, img1, img2))
        records.update(cli_raster_files(cap, smi, td, img1, img2))
        records.update(cli_codecs_icons(cap, smi, td, img1, img2))
        records.update(cli_legacy_rasters(cap, smi, td, img1, img2))
        records.update(cli_jpeg_codings(cap, smi, td, img1, img2))
        records.update(cli_pillow_rest(cap, smi, td, img1, img2))
        records.update(cli_block_textures(cap, smi, td, img1, img2))
        records.update(cli_fli_pcd_writers(cap, smi, td, img1, img2, tifs))
        records.update(cli_jpeg2000(cap, smi, td))
        records.update(cli_depth_writers(cap, smi, td, tifs, mem, texture))
        records.update(cli_jpeg2000_writers(cap, smi, td, tifs, mem))
        records.update(cli_webp_writer(cap, smi, td, tifs, mem))
        records.update(cli_avif(cap, smi, td))
        records.update(cli_avif_writer(cap, smi, td, tifs, mem))
        records.update(cli_avif_depth(cap, smi, td))
        records.update(cli_avif_scale(cap, smi, td))
    torch.cuda.empty_cache()
    return records


def cli_jpeg_depth_map(cap, smi: str, td: str, tifs: list[str], timed_rgb: dict) -> dict:
    """Phase 8 (e): the SEM TIFF pair -> .jpg depth map (--projection=
    parallel --interpolation=none): the file is the port's encoder on the
    RGB of the .png run on the same files, decodes within JPEG's error of
    it, and the encoder gives Pillow's bytes (committed SHA-256) on
    encoder_cases(); the encode timed on each of `timed_rgb`'s images."""
    from cybervision_tpu_torch.imageio import open_image
    from cybervision_tpu_torch.imageio.jpeg_encode import encode_jpeg

    label = f"(e) SEM TIFF pair {SIZE}x{SIZE}+{SEM_DATABAR} -> JPEG depth map"
    argv = ["--projection=parallel", "--interpolation=none", *tifs]
    png_path, jpg_path = os.path.join(td, "depth_e.png"), os.path.join(td, "depth.jpg")
    cap.main([*argv, png_path])
    jpg = cap.main([*argv, jpg_path])
    rgb = np.ascontiguousarray(read_png(png_path)[:, :, :3])
    with open(jpg_path, "rb") as fh:
        data = fh.read()
    same = data == encode_jpeg(rgb)
    mode, decoded, _ = open_image(jpg_path).decode()
    err = decoded.astype(np.float64) - rgb
    psnr = 10 * np.log10(255.0**2 / max(float(np.mean(err**2)), 1e-12))
    with open(FORMATS_SHA256) as fh:
        committed = json.load(fh)["encoder"]
    hashes = {name: hashlib.sha256(encode_jpeg(px)).hexdigest() == committed[name]
              for name, px in encoder_cases()}
    times = {}
    for name, img in timed_rgb.items():
        encode_jpeg(img)
        t0 = time.perf_counter()
        n = len(encode_jpeg(img))
        times[name] = time.perf_counter() - t0
        print(f"{label}: encode_jpeg at {name} {times[name]:.4f} s, {n} bytes")
    rec = cli_record("(e) JPEG depth map", jpg["seconds"], jpg["rec"].phases, jpg["decode"],
                     jpg["launches"], smi, jpg["encode"],
                     encode_s_at={k: round(v, 4) for k, v in times.items()})
    print(f"{label}: {rgb.shape[1]}x{rgb.shape[0]}, {len(data)} bytes; the file equal to"
          f" encode_jpeg of the PNG run's RGB {same}; decoded {mode}, |err| mean"
          f" {np.abs(err).mean():.4f}, max {np.abs(err).max():.0f}, PSNR {psnr:.2f} dB;"
          f" encoder bytes equal to Pillow's on {sum(hashes.values())} of {len(hashes)}"
          f" committed arrays")
    if not same or mode != "RGB" or decoded.shape != rgb.shape or psnr < JPEG_PSNR_MIN_DB:
        raise AssertionError(f"{label}: the JPEG depth map is not the encoded PNG run")
    if not all(hashes.values()):
        raise AssertionError(f"{label}: encoder bytes differ from Pillow's on"
                             f" {[k for k, v in hashes.items() if not v]}")
    return {"jpeg depth map": rec}


@functools.lru_cache(maxsize=2)
def _pair_scene(w: int, h: int):
    """render_perspective of phase 6's pair at w x h with the exact focal
    length, rendered once a size: every phase 8 pair run of that size
    (cli_exif_jpeg_pair) gates against the same scene. Callers do not
    write to it."""
    return render_perspective(w, h, PERSP_CAMS[:1], exact_focal=True)


def cli_exif_jpeg_pair(cap, smi: str, td: str, run: str, label: str, paths: list[str], srcs,
                       checks: dict, size: tuple[int, int], focal_arg: int | None = None,
                       reference: bool = True) -> dict:
    """Phase 8 (c), (f), (j) and (k): a JPEG, WebP or TGA pair of phase 6's
    scene at `size` -> OBJ, with EXIF 41989 = 43 and no --focal-length, or
    with --focal-length=`focal_arg` (a file without EXIF). `checks` holds
    the caller's gates on the decoded planes (`srcs`); K must be the 43 mm
    K, the OBJ the in-memory run's on the decoded planes (unless
    `reference` is False: no in-memory run), and phase 6's camera and
    depth gates must hold."""
    from cybervision_tpu_torch.config import ReconstructionConfig
    from cybervision_tpu_torch.images import SourceImage
    from cybervision_tpu_torch.reconstruction import Reconstruction

    _, depth1, k_true, cams = _pair_scene(*size)
    checks["K equal to the 43 mm K"] = all(np.array_equal(s.calibration_matrix(focal_arg), k_true)
                                           for s in srcs)
    print(f"{label}: " + "; ".join(f"{k} {v}" for k, v in checks.items()))
    if not all(checks.values()):
        raise AssertionError(f"{label}: the files do not decode to Pillow's planes and K")
    ref_obj, out = os.path.join(td, "mem_pair.obj"), os.path.join(td, "pair.obj")
    if reference:
        mem = []
        for s in srcs:
            src = SourceImage(s.img, focal_length_35mm=PERSP_FOCAL_35MM)
            src.load_rgb_plane = functools.partial(np.array, s.load_rgb_plane())
            mem.append(src)
        Reconstruction(["v0", "v1"], ref_obj, ReconstructionConfig(), quiet=True, images=mem).run()
    cli = cap.main([*([f"--focal-length={focal_arg}"] if focal_arg else []), *paths, out])
    rec = cli_record(run, cli["seconds"], cli["rec"].phases, cli["decode"], cli["launches"], smi)
    if reference:
        same = _sha(out) == _sha(ref_obj)
        print(f"{label}: OBJ equal to the in-memory run's {same}")
        if not same:
            raise AssertionError(f"{label}: the OBJ differs from the in-memory run's")
    else:
        print(f"{label}: no in-memory run (the camera and depth gates below)")
    check_pair_failures(label, cli["rec"], 2)
    perspective_gates(label, cli["rec"], cams, depth1, out, 2000, None, [POSE_TOL_DEG])
    return rec


def cli_progressive_pair(cap, smi: str, td: str) -> dict:
    """Phase 8 (f): the full-width pair as committed progressive JPEGs:
    the decoded planes have the committed SHA-256 of Pillow's and equal
    the baseline twins'; then cli_exif_jpeg_pair's gates."""
    from cybervision_tpu_torch.images import SourceImage

    w, h = round(PERSP_W * FULL_SCALE), round(PERSP_H * FULL_SCALE)
    with open(FORMATS_SHA256) as fh:
        committed = json.load(fh)["decoder"]
    srcs = [SourceImage.load(p) for p in PERSP_FULL_JPEGS]
    twins = [SourceImage.load(p) for p in PERSP_FULL_TWINS]
    sha_ok = all(
        hashlib.sha256(s.img.tobytes()).hexdigest() == committed[os.path.basename(p)]["l"]
        and hashlib.sha256(s.load_rgb_plane().tobytes()).hexdigest()
        == committed[os.path.basename(p)]["rgb"]
        for s, p in zip(srcs, PERSP_FULL_JPEGS))
    twin_ok = all(np.array_equal(s.img, t.img)
                  and np.array_equal(s.load_rgb_plane(), t.load_rgb_plane())
                  for s, t in zip(srcs, twins))
    return {"progressive jpeg": cli_exif_jpeg_pair(
        cap, smi, td, "(f) progressive JPEG pair", f"(f) progressive JPEG pair {w}x{h} -> OBJ",
        PERSP_FULL_JPEGS, srcs, {"planes equal to Pillow's (SHA-256)": sha_ok,
                                 "equal to the baseline twins'": twin_ok}, (w, h))}


def cli_tiff_layouts(cap, smi: str, td: str, img1, img2, ref_sha: str) -> dict:
    """Phase 8 (g): (a)'s SEM pair rewritten by write_tiff as tiled,
    planar and BigTIFF files -> PLY, each byte-equal to (a)'s."""
    records = {}
    for layout in ("tiled", "planar", "bigtiff"):
        label = f"(g) SEM pair as {layout} TIFFs -> PLY"
        paths = sem_tiff_pair(td, img1, img2, layout)
        out = os.path.join(td, f"{layout}.ply")
        run = cap.main(["--projection=parallel", "--mesh=vertex-colors", *paths, out])
        records[f"tiff {layout}"] = cli_record(f"(g) {layout} TIFF", run["seconds"],
                                               run["rec"].phases, run["decode"],
                                               run["launches"], smi)
        same = _sha(out) == ref_sha
        print(f"{label}: {[os.path.getsize(p) for p in paths]} bytes; PLY equal to (a)'s {same}")
        if not same:
            raise AssertionError(f"{label}: the PLY differs from (a)'s")
    return records


def tint(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) RGB of a gray image with a colour cast, so that a YCbCr
    file's chroma planes vary."""
    v = img.astype(np.float64)
    return np.round(np.stack([v, 0.9 * v + 12.0, 0.8 * v + 25.0], axis=-1)).astype(np.uint8)


def instrument_files(td: str, img1, img2) -> dict[str, list[str]]:
    """Phase 8 (h) and (i)'s inputs, the pair as: 8-bit gray-palette BMPs
    ("bmp"), 32-bit float TIFFs (the gray values plus a seeded fraction
    below 0.99, which convert("L") truncates away), JPEG-compressed YCbCr
    TIFFs of the tinted pair, and RLE8 BMPs. tests/gen_torch_formats_fixture.py
    writes the same files and commits the SHA-256 of Pillow's planes of
    them."""
    rng = np.random.RandomState(61)
    files: dict[str, list[str]] = {"bmp": [], "float tiff": [], "jpeg tiff": [], "rle8 bmp": []}
    for k, img in enumerate((img1, img2)):
        base = os.path.join(td, f"instrument_{k}")
        files["bmp"].append(base + ".bmp")
        write_bmp(files["bmp"][-1], img)
        files["float tiff"].append(base + "_float.tif")
        frac = rng.uniform(0, 0.99, img.shape).astype(np.float32)
        write_tiff(files["float tiff"][-1], img.astype(np.float32) + frac, None, "float")
        files["jpeg tiff"].append(base + "_jpeg.tif")
        write_tiff(files["jpeg tiff"][-1], tint(img), None, "jpeg")
        files["rle8 bmp"].append(base + "_rle8.bmp")
        write_bmp(files["rle8 bmp"][-1], img, rle=True)
    return files


def gif_pair(td: str, img1, img2) -> list[str]:
    """Phase 8 (j)'s GIF pair: phase 3's images as 8-bit gray GIFs
    (write_gif), the first in row order, the second interlaced."""
    paths = [os.path.join(td, f"gif_{k}.gif") for k in range(2)]
    write_gif(paths[0], img1)
    write_gif(paths[1], img2, interlace=True)
    return paths


class _NoPillow:
    """A sys.meta_path finder under which every import of Pillow raises,
    while a `with` block runs (Pillow's modules already loaded are set
    aside meanwhile)."""

    def find_spec(self, name, path=None, target=None):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("Pillow is blocked in this run")

    def __enter__(self):
        self.loaded = {m: sys.modules.pop(m) for m in list(sys.modules)
                       if m == "PIL" or m.startswith("PIL.")}
        sys.meta_path.insert(0, self)
        return self

    def __exit__(self, *exc):
        sys.meta_path.remove(self)
        sys.modules.update(self.loaded)
        return False


def _plane_sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def cli_instrument_files(cap, smi: str, td: str, img1, img2) -> dict:
    """Phase 8 (h) and (i): instrument_files' pairs through cli.main. (h)
    the gray-palette BMPs -> PLY, equal to reconstruct's on the arrays;
    (i) the float TIFFs -> .tif, the JPEG-in-TIFFs -> .tif and the RLE8
    BMPs -> .bmp depth maps (--interpolation=none), each file equal to
    the port's writer (imageio.rgba_encode) on the RGBA of the in-memory
    run on the decoded planes. Every decoded plane has the committed
    SHA-256 of Pillow's; the lossless files' gray planes are the arrays.
    The cli.main runs have every import of Pillow blocked (_NoPillow)."""
    from cybervision_tpu_torch.config import (
        InterpolationMode, MeshMode, ProjectionMode, ReconstructionConfig,
    )
    from cybervision_tpu_torch.images import SourceImage
    from cybervision_tpu_torch.imageio.rgba_encode import encode_bmp, encode_tiff
    from cybervision_tpu_torch.reconstruction import reconstruct

    t0 = time.perf_counter()
    files = instrument_files(td, img1, img2)
    written = time.perf_counter() - t0
    with open(FORMATS_SHA256) as fh:
        committed = json.load(fh)["phase8"]
    srcs, hashes = {}, {}
    for kind, paths in files.items():
        srcs[kind] = [SourceImage.load(p) for p in paths]
        hashes[kind] = all(
            _plane_sha(s.img) == committed[os.path.basename(p)]["l"]
            and _plane_sha(s.load_rgb_plane()) == committed[os.path.basename(p)]["rgb"]
            for s, p in zip(srcs[kind], paths))
    lossless = all(np.array_equal(s.img, im) for kind in ("bmp", "float tiff", "rle8 bmp")
                   for s, im in zip(srcs[kind], (img1, img2)))
    print(f"(h)/(i) files written in {written:.2f} s"
          f" ({[os.path.getsize(p) for ps in files.values() for p in ps]} bytes); planes equal to"
          f" Pillow's (SHA-256) {hashes}; lossless gray planes equal to the arrays {lossless}")
    if not all(hashes.values()) or not lossless:
        raise AssertionError("(h)/(i): the decoded planes are not Pillow's")
    aff = ProjectionMode.AFFINE
    plain = [SourceImage(im) for im in (img1, img2)]
    records = {}

    label = f"(h) gray-palette BMP pair {SIZE}x{SIZE} -> PLY"
    ref_ply, out = os.path.join(td, "mem_h.ply"), os.path.join(td, "bmp.ply")
    reconstruct(["a", "b"], ref_ply, ReconstructionConfig(projection=aff,
                mesh=MeshMode.VERTEX_COLORS), quiet=True, images=plain)
    with _NoPillow():
        run = cap.main(["--projection=parallel", "--mesh=vertex-colors", *files["bmp"], out])
        pil = any(m == "PIL" or m.startswith("PIL.") for m in sys.modules)
    records["bmp ply"] = cli_record("(h) gray-palette BMP", run["seconds"], run["rec"].phases,
                                    run["decode"], run["launches"], smi)
    same = _sha(out) == _sha(ref_ply)
    print(f"{label}: PLY equal to the in-memory run's {same}; Pillow installed"
          f" {importlib.util.find_spec('PIL') is not None}, blocked in the run, imported {pil}")
    if not same or pil:
        raise AssertionError(f"{label}: the PLY differs from the in-memory run's, or Pillow was used")

    cfg = ReconstructionConfig(projection=aff, interpolation=InterpolationMode.NONE)
    mem_rgba = {}
    for key, images in (("arrays", plain), ("jpeg", [SourceImage(s.img) for s in srcs["jpeg tiff"]])):
        ref_png = os.path.join(td, f"mem_i_{key}.png")
        reconstruct(["a", "b"], ref_png, cfg, quiet=True, images=images)
        mem_rgba[key] = read_png(ref_png)
    for kind, ext, encode, ref in (("float tiff", ".tif", encode_tiff, "arrays"),
                                   ("jpeg tiff", ".tif", encode_tiff, "jpeg"),
                                   ("rle8 bmp", ".bmp", encode_bmp, "arrays")):
        label = f"(i) {kind} pair -> {ext} depth map"
        out = os.path.join(td, f"depth_{kind.replace(' ', '_')}{ext}")
        with _NoPillow():
            run = cap.main(["--projection=parallel", "--interpolation=none", *files[kind], out])
        records[kind] = cli_record(f"(i) {kind}", run["seconds"], run["rec"].phases, run["decode"],
                                   run["launches"], smi, run["encode"])
        with open(out, "rb") as fh:
            same = fh.read() == encode(mem_rgba[ref])
        print(f"{label}: {mem_rgba[ref].shape[1]}x{mem_rgba[ref].shape[0]}, the file equal to the"
              f" port's writer on the in-memory run's RGBA {same}")
        if not same:
            raise AssertionError(f"{label}: the depth map differs from the in-memory run's")
    return records


def cli_gif_webp(cap, smi: str, td: str, img1, img2) -> dict:
    """Phase 8 (j), with every import of Pillow blocked (_NoPillow): (1)
    phase 3's pair as gray GIFs (gif_pair) -> PLY, equal to reconstruct's
    on the arrays; (2) the full-width pair as the committed lossy WebPs
    (ALPH, VP8, EXIF) and (3) BASELINE #3's views as the committed
    lossless WebPs (VP8L, EXIF) -> OBJ, no --focal-length, with
    cli_exif_jpeg_pair's gates. Every decoded plane has the committed
    SHA-256 of Pillow's ("gif_webp"); the GIF planes are the arrays and
    every WebP's EXIF focal length is 43."""
    from cybervision_tpu_torch.config import MeshMode, ProjectionMode, ReconstructionConfig
    from cybervision_tpu_torch.images import SourceImage, read_metadata
    from cybervision_tpu_torch.reconstruction import reconstruct

    with open(FORMATS_SHA256) as fh:
        committed = json.load(fh)["gif_webp"]
    t0 = time.perf_counter()
    gifs = gif_pair(td, img1, img2)
    written = time.perf_counter() - t0
    records = {}
    with _NoPillow():
        srcs = {}
        for kind, paths in (("gif", gifs), ("lossy webp", PERSP_FULL_WEBPS),
                            ("lossless webp", PERSP_WEBPS_LOSSLESS)):
            srcs[kind] = [SourceImage.load(p) for p in paths]
            ok = all(_plane_sha(s.img) == committed[os.path.basename(p)]["l"]
                     and _plane_sha(s.load_rgb_plane()) == committed[os.path.basename(p)]["rgb"]
                     for s, p in zip(srcs[kind], paths))
            focal = [read_metadata(p).focal_length_35mm for p in paths]
            print(f"(j) {kind} files {[os.path.getsize(p) for p in paths]} bytes: planes equal to"
                  f" Pillow's (SHA-256) {ok}; EXIF focal lengths {focal}")
            if not ok or focal != ([None, None] if kind == "gif" else [PERSP_FOCAL_35MM] * 2):
                raise AssertionError(f"(j) {kind}: the planes are not Pillow's or the focal"
                                     " length is not the file's")
        lossless = all(np.array_equal(s.img, im) for s, im in zip(srcs["gif"], (img1, img2)))
        label = f"(j) gray GIF pair {SIZE}x{SIZE} -> PLY"
        print(f"{label}: written in {written:.2f} s (write_gif); gray planes equal to the arrays"
              f" {lossless}")
        if not lossless:
            raise AssertionError(f"{label}: the GIF planes are not the arrays")
        ref_ply, out = os.path.join(td, "mem_j.ply"), os.path.join(td, "gif.ply")
        reconstruct(["a", "b"], ref_ply, ReconstructionConfig(
            projection=ProjectionMode.AFFINE, mesh=MeshMode.VERTEX_COLORS), quiet=True,
            images=[SourceImage(im) for im in (img1, img2)])
        run = cap.main(["--projection=parallel", "--mesh=vertex-colors", *gifs, out])
        records["gif ply"] = cli_record("(j) gray GIF", run["seconds"], run["rec"].phases,
                                        run["decode"], run["launches"], smi)
        same = _sha(out) == _sha(ref_ply)
        print(f"{label}: PLY equal to the in-memory run's {same}")
        if not same:
            raise AssertionError(f"{label}: the PLY differs from the in-memory run's")
        w, h = round(PERSP_W * FULL_SCALE), round(PERSP_H * FULL_SCALE)
        records["lossy webp"] = cli_exif_jpeg_pair(
            cap, smi, td, "(j) lossy WebP pair", f"(j) lossy WebP pair {w}x{h} -> OBJ",
            PERSP_FULL_WEBPS, srcs["lossy webp"], {}, (w, h))
        records["lossless webp"] = cli_exif_jpeg_pair(
            cap, smi, td, "(j) lossless WebP pair",
            f"(j) lossless WebP pair {PERSP_W}x{PERSP_H} -> OBJ", PERSP_WEBPS_LOSSLESS,
            srcs["lossless webp"], {}, (PERSP_W, PERSP_H))
        pil = any(m == "PIL" or m.startswith("PIL.") for m in sys.modules)
    print(f"(j) Pillow imported during the runs {pil}")
    if pil:
        raise AssertionError("(j): Pillow was imported")
    return records


def write_pgm16(path: str, img: np.ndarray) -> None:
    """A 16-bit binary PGM (P5, maxval 65535) of the gray values, unscaled:
    Pillow opens it as "I" and convert("L") clips, so its plane is the
    image."""
    h, w = img.shape
    with open(path, "wb") as fh:
        fh.write(b"P5\n%d %d\n65535\n" % (w, h) + np.ascontiguousarray(img, ">u2").tobytes())


def write_spider(path: str, img: np.ndarray) -> None:
    """A little-endian SPIDER 2D image (iform 1) of float32 `img`: a
    header of whole records of 4 * width bytes, at least 1024 bytes, as
    SPIDER writes it (nslice 1, nrow, iform, nsam, labrec, labbyt,
    lenbyt)."""
    h, w = img.shape
    lenbyt = 4 * w
    labrec = -(-1024 // lenbyt)
    fields = np.zeros(labrec * lenbyt // 4, "<f4")
    fields[[0, 1, 4, 11, 12, 21, 22]] = (1, h, 1, w, labrec, labrec * lenbyt, lenbyt)
    with open(path, "wb") as fh:
        fh.write(fields.tobytes() + np.ascontiguousarray(img, "<f4").tobytes())


def _tga_rle_row(px: np.ndarray) -> bytes:
    """One row of (W, 3) BGR pixels as TGA RLE packets: runs of 2-128
    equal pixels, the rest as literals of up to 128."""
    out, w, i = bytearray(), len(px), 0
    same = np.all(px[1:] == px[:-1], axis=1)
    while i < w:
        k = 1
        while i + k < w and k < 128 and same[i + k - 1]:
            k += 1
        if k > 1:
            out += bytes([0x80 | (k - 1)]) + px[i].tobytes()
        else:
            while i + k < w and k < 128 and not same[i + k - 1]:
                k += 1
            if i + k < w and k > 1:
                k -= 1  # leave the run's first pixel to the run
            out += bytes([k - 1]) + px[i : i + k].tobytes()
        i += k
    return bytes(out)


def write_tga_rle(path: str, rgb: np.ndarray) -> None:
    """An RLE true-colour TGA (image type 10, 24-bit BGR, rows bottom-up)
    of (H, W, 3) RGB, each row's packets within the row."""
    h, w = rgb.shape[:2]
    bgr = np.ascontiguousarray(rgb[::-1, :, ::-1])
    with open(path, "wb") as fh:
        fh.write(struct.pack("<BBBHHBHHHHBB", 0, 0, 10, 0, 0, 0, 0, 0, w, h, 24, 0))
        fh.write(b"".join(_tga_rle_row(row) for row in bgr))


def cmyk(rgb: np.ndarray) -> np.ndarray:
    """(H, W, 4) CMYK of (H, W, 3) RGB by plain grey-component
    replacement: K the least of 255 - R, G, B, the rest of each ink in C,
    M and Y."""
    inks = 255 - rgb.astype(np.int16)
    k = inks.min(axis=2, keepdims=True)
    return np.concatenate([inks - k, k], axis=2).astype(np.uint8)


def raster_files(td: str, img1, img2) -> dict[str, list[str]]:
    """Phase 8 (k)'s inputs: phase 3's pair as 16-bit binary PGMs
    (write_pgm16), as little-endian SPIDER files (write_spider: the gray
    values plus a seeded fraction below 0.99, which convert("L")
    truncates away) and as CMYK TIFFs of the tinted pair (write_tiff
    "cmyk"); BASELINE #3's views (render_perspective at 320x256, the 43 mm
    focal length, tinted) as RLE TGAs (write_tga_rle).
    tests/gen_torch_formats_fixture.py writes the same files and commits
    the SHA-256 of Pillow's planes of them ("raster")."""
    rng = np.random.RandomState(62)
    files: dict[str, list[str]] = {"pgm": [], "spider": [], "tga": [], "cmyk tiff": []}
    views, _, _, _ = render_perspective(PERSP_W, PERSP_H, PERSP_CAMS[:1], exact_focal=True)
    for k, (img, view) in enumerate(zip((img1, img2), views)):
        base = os.path.join(td, f"raster_{k}")
        files["pgm"].append(base + ".pgm")
        write_pgm16(files["pgm"][-1], img)
        files["spider"].append(base + ".spi")
        frac = rng.uniform(0, 0.99, img.shape).astype(np.float32)
        write_spider(files["spider"][-1], img.astype(np.float32) + frac)
        files["tga"].append(base + ".tga")
        write_tga_rle(files["tga"][-1], tint(view))
        files["cmyk tiff"].append(base + "_cmyk.tif")
        write_tiff(files["cmyk tiff"][-1], cmyk(tint(img)), None, "cmyk")
    return files


def cli_raster_files(cap, smi: str, td: str, img1, img2) -> dict:
    """Phase 8 (k), with every import of Pillow blocked (_NoPillow):
    raster_files' pairs through cli.main. The PGMs -> PLY and the SPIDER
    files -> PNG depth map (--interpolation=none), each equal to
    reconstruct's on the arrays; the RLE TGAs -> OBJ with
    --focal-length=43 (TGA carries no EXIF), with cli_exif_jpeg_pair's
    gates; the CMYK TIFFs -> PLY, equal to reconstruct's on the decoded
    planes. Every decoded plane has the committed SHA-256 of Pillow's
    ("raster"); the PGM and SPIDER gray planes are the arrays."""
    from cybervision_tpu_torch.config import (
        InterpolationMode, MeshMode, ProjectionMode, ReconstructionConfig,
    )
    from cybervision_tpu_torch.images import SourceImage
    from cybervision_tpu_torch.reconstruction import reconstruct

    with open(FORMATS_SHA256) as fh:
        committed = json.load(fh)["raster"]
    t0 = time.perf_counter()
    files = raster_files(td, img1, img2)
    written = time.perf_counter() - t0
    aff = ProjectionMode.AFFINE
    ply_cfg = ReconstructionConfig(projection=aff, mesh=MeshMode.VERTEX_COLORS)
    records = {}
    with _NoPillow():
        srcs, hashes = {}, {}
        for kind, paths in files.items():
            srcs[kind] = [SourceImage.load(p) for p in paths]
            hashes[kind] = all(
                _plane_sha(s.img) == committed[os.path.basename(p)]["l"]
                and _plane_sha(s.load_rgb_plane()) == committed[os.path.basename(p)]["rgb"]
                for s, p in zip(srcs[kind], paths))
        lossless = all(np.array_equal(s.img, im) for kind in ("pgm", "spider")
                       for s, im in zip(srcs[kind], (img1, img2)))
        print(f"(k) files written in {written:.2f} s"
              f" ({[os.path.getsize(p) for ps in files.values() for p in ps]} bytes); planes equal"
              f" to Pillow's (SHA-256) {hashes}; PGM and SPIDER gray planes equal to the arrays"
              f" {lossless}")
        if not all(hashes.values()) or not lossless:
            raise AssertionError("(k): the decoded planes are not Pillow's")
        plain = [SourceImage(im) for im in (img1, img2)]

        label = f"(k) 16-bit PGM pair {SIZE}x{SIZE} -> PLY"
        ref_ply, out = os.path.join(td, "mem_k.ply"), os.path.join(td, "pgm.ply")
        reconstruct(["a", "b"], ref_ply, ply_cfg, quiet=True, images=plain)
        run = cap.main(["--projection=parallel", "--mesh=vertex-colors", *files["pgm"], out])
        records["pgm ply"] = cli_record("(k) 16-bit PGM", run["seconds"], run["rec"].phases,
                                        run["decode"], run["launches"], smi)
        same = _sha(out) == _sha(ref_ply)
        print(f"{label}: PLY equal to the in-memory run's {same}")
        if not same:
            raise AssertionError(f"{label}: the PLY differs from the in-memory run's")

        label = f"(k) SPIDER pair {SIZE}x{SIZE} -> PNG depth map"
        ref_png, out = os.path.join(td, "mem_k.png"), os.path.join(td, "spider.png")
        reconstruct(["a", "b"], ref_png, ReconstructionConfig(
            projection=aff, interpolation=InterpolationMode.NONE), quiet=True, images=plain)
        run = cap.main(["--projection=parallel", "--interpolation=none", *files["spider"], out])
        records["spider png"] = cli_record("(k) SPIDER", run["seconds"], run["rec"].phases,
                                           run["decode"], run["launches"], smi, run["encode"])
        same = _sha(out) == _sha(ref_png)
        print(f"{label}: PNG equal to the in-memory run's {same}")
        if not same:
            raise AssertionError(f"{label}: the PNG differs from the in-memory run's")

        records["tga obj"] = cli_exif_jpeg_pair(
            cap, smi, td, "(k) RLE TGA pair", f"(k) RLE TGA pair {PERSP_W}x{PERSP_H} -> OBJ",
            files["tga"], srcs["tga"], {}, (PERSP_W, PERSP_H), focal_arg=PERSP_FOCAL_35MM)

        label = f"(k) CMYK TIFF pair {SIZE}x{SIZE} -> PLY"
        mem = []
        for s in srcs["cmyk tiff"]:
            src = SourceImage(s.img)
            src.load_rgb_plane = functools.partial(np.array, s.load_rgb_plane())
            mem.append(src)
        ref_ply, out = os.path.join(td, "mem_k_cmyk.ply"), os.path.join(td, "cmyk.ply")
        reconstruct(["a", "b"], ref_ply, ply_cfg, quiet=True, images=mem)
        run = cap.main(["--projection=parallel", "--mesh=vertex-colors", *files["cmyk tiff"], out])
        records["cmyk tiff ply"] = cli_record("(k) CMYK TIFF", run["seconds"], run["rec"].phases,
                                              run["decode"], run["launches"], smi)
        same = _sha(out) == _sha(ref_ply)
        print(f"{label}: PLY equal to the in-memory run on the decoded planes {same}")
        if not same:
            raise AssertionError(f"{label}: the PLY differs from the in-memory run's")
        pil = any(m == "PIL" or m.startswith("PIL.") for m in sys.modules)
    print(f"(k) Pillow imported during the runs {pil}")
    if pil:
        raise AssertionError("(k): Pillow was imported")
    return records


def exif_focal_block(focal: int) -> bytes:
    """A little-endian EXIF block (TIFF header and IFD0) with
    FocalLengthIn35mmFilm (41989, SHORT) = `focal`."""
    return (b"II*\0" + struct.pack("<IHHHIHH", 8, 1, 41989, 3, 1, focal, 0) + b"\0" * 4)


def write_png_text_exif(path: str, rgb: np.ndarray, focal: int) -> None:
    """png_encode.encode_png of (H, W, 3) RGB, with the photo's EXIF (41989 =
    `focal`) only as ImageMagick carries it into a PNG: a "Raw profile
    type exif" zTXt chunk after the image data (a blank line, "exif", the
    length, then the hex of "Exif\\0\\0" and the block, 72 digits a line)."""
    from cybervision_tpu_torch.imageio.png_encode import chunk as _png_chunk, encode_png

    block = b"Exif\0\0" + exif_focal_block(focal)
    digits = block.hex()
    text = "\nexif\n" + f"{len(block):8d}\n" + "\n".join(
        digits[k : k + 72] for k in range(0, len(digits), 72)) + "\n"
    chunk = _png_chunk(b"zTXt", b"Raw profile type exif\0\0" + zlib.compress(text.encode()))
    data = encode_png(np.ascontiguousarray(rgb))
    with open(path, "wb") as fh:
        fh.write(data[:-12] + chunk + data[-12:])  # before IEND


def icon_dib(px: np.ndarray, bits: int, mask: np.ndarray | None,
             palette: np.ndarray | None = None) -> bytes:
    """The bitmap of an ICO or CUR entry: a 40-byte info header whose
    height counts the XOR bitmap and the AND mask, the palette (8 bits),
    the rows bottom-up (8-bit indices, 24-bit BGR or 32-bit BGRA), then
    the 1-bit AND mask (set bits transparent, rows padded to 32 bits)."""
    h, w = px.shape[:2]
    if bits == 8:
        rows, pal = px, np.concatenate([palette[:, ::-1], np.zeros((256, 1), np.uint8)], axis=1)
    else:
        rows, pal = px[:, :, [2, 1, 0, 3][: bits // 8]], np.zeros((0, 4), np.uint8)
    stride = (w * bits // 8 + 3) & ~3
    xor = np.zeros((h, stride), np.uint8)
    xor[:, : w * bits // 8] = rows.reshape(h, -1)
    data = struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, bits, 0, 0, 0, 0, len(pal), 0)
    data += pal.tobytes() + xor[::-1].tobytes()
    if mask is not None:
        packed = np.packbits(mask.astype(np.uint8), axis=1)
        and_rows = np.zeros((h, (w + 31) // 32 * 4), np.uint8)
        and_rows[:, : packed.shape[1]] = packed
        data += and_rows[::-1].tobytes()
    return data


def icon_directory(magic: int, entries) -> bytes:
    """An ICO (magic 1) or CUR (2) file of (width, height, bpp, data)
    entries, the data after the directory in order."""
    out = struct.pack("<HHH", 0, magic, len(entries))
    offset, body = 6 + 16 * len(entries), b""
    for w, h, bpp, data in entries:
        out += struct.pack("<BBBBHHII", w % 256, h % 256, 0, 0, 1, bpp, len(data),
                           offset + len(body))
        body += data
    return out + body


def icns_rle_plane(plane: bytes) -> bytes:
    """One plane of an ICNS 24-bit icon run-length coded
    (IcnsImagePlugin.read_32): runs of 3-130 equal bytes as 0x80 + n - 3
    and the byte, the rest as literals of up to 128 bytes."""
    out, i, n = bytearray(), 0, len(plane)
    while i < n:
        run = 1
        while i + run < n and run < 130 and plane[i + run] == plane[i]:
            run += 1
        if run >= 3:
            out += bytes([run + 125, plane[i]])
            i += run
            continue
        j = i
        while j < n and j - i < 128 and not (j + 2 < n and plane[j] == plane[j + 1] == plane[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + plane[i:j]
        i = j
    return bytes(out)


def icns_file(entries) -> bytes:
    body = b"".join(kind + struct.pack(">I", 8 + len(data)) + data for kind, data in entries)
    return b"icns" + struct.pack(">I", 8 + len(body)) + body


def jp2_boxes(data: bytes) -> list[list]:
    """The [type, body] of each JP2 box in `data`."""
    out, pos = [], 0
    while pos + 8 <= len(data):
        length, kind = struct.unpack_from(">I4s", data, pos)
        length = length or len(data) - pos
        out.append([kind, data[pos + 8 : pos + length]])
        pos += length
    return out


def jp2_box(kind: bytes, body: bytes) -> bytes:
    """One JP2 box of `kind` around `body`."""
    return struct.pack(">I", len(body) + 8) + kind + body


def jp2_edited(data: bytes, edit) -> bytes:
    """A JP2 file with its jp2h box's sub-boxes, a list of [type, body],
    replaced by edit(sub-boxes)."""
    out = b""
    for kind, body in jp2_boxes(data):
        if kind == b"jp2h":
            body = b"".join(jp2_box(k, b) for k, b in edit(jp2_boxes(body)))
        out += jp2_box(kind, body)
    return out


def jp2_with_palette(data: bytes, colours, depths=None, cmap=True, enumcs=16) -> bytes:
    """A JP2 file of one or two components with a pclr box of `colours`
    (tuples of 1-4 entries; `depths` the bytes of each column's bit depth,
    7 for 8 bits) and a cmap box mapping the first component through it,
    its colr box set to `enumcs` (sRGB, which Pillow's "P" unpacker
    needs)."""
    npc = len(colours[0])
    depths = depths or [7] * npc
    pclr = struct.pack(">HB", len(colours), npc) + bytes(depths) + b"".join(
        bytes(c) for c in colours)

    def edit(subs):
        subs = [[k, struct.pack(">BBBI", 1, 0, 0, enumcs) if k == b"colr" else b]
                for k, b in subs]
        subs.append([b"pclr", pclr])
        if cmap:
            subs.append([b"cmap", b"".join(struct.pack(">HBB", 0, 1, k) for k in range(npc))])
        return subs

    return jp2_edited(data, edit)


def icon_files(td: str) -> list[str]:
    """Phase 8 (l)'s icons, cut from BASELINE #3's first view (tint): an
    ICO of an 8-bit palette entry with an AND mask (beside a smaller
    32-bit one), an ICO of a 32-bit entry (alpha in every fourth byte), an
    ICO of a PNG entry, a CUR of a 24-bit bitmap with an AND mask, an ICNS
    of an RLE it32 icon with its t8mk mask (beside a smaller PNG) and an
    ICNS whose 128x128 entry is a PNG. tests/gen_torch_formats_fixture.py
    writes the same files and commits the SHA-256 of Pillow's planes of
    them ("icons")."""
    from cybervision_tpu_torch.imageio.png_encode import encode_png

    views, _, _, _ = render_perspective(PERSP_W, PERSP_H, PERSP_CAMS[:1], exact_focal=True)
    rgb = tint(views[0])
    rng = np.random.RandomState(63)
    yy, xx = np.mgrid[:128, :128]
    disc = (yy - 64) ** 2 + (xx - 64) ** 2 > 60**2  # transparent outside a disc

    def alpha(n):
        return rng.randint(0, 256, (n, n)).astype(np.uint8)

    def rgba(y, x, n):
        return np.dstack([rgb[y : y + n, x : x + n], alpha(n)])

    gray = rgb[40:88, 100:148].mean(axis=2).astype(np.uint8)
    ramp = np.stack([np.arange(256), 255 - np.arange(256), np.arange(256) // 2], 1).astype(np.uint8)
    files = {
        "icon_bmp8.ico": icon_directory(1, [
            (48, 48, 8, icon_dib(gray, 8, disc[:48, :48], ramp)),
            (24, 24, 32, icon_dib(rgba(0, 0, 24), 32, None))]),
        "icon_bmp32.ico": icon_directory(1, [(32, 32, 32, icon_dib(rgba(120, 60, 32), 32, None))]),
        "icon_png.ico": icon_directory(1, [(64, 64, 32, encode_png(rgba(90, 200, 64)))]),
        "cursor.cur": icon_directory(2, [(32, 32, 24, icon_dib(rgb[10:42, 250:282], 24,
                                                               disc[40:72, 40:72]))]),
        "icon_rle.icns": icns_file([
            (b"it32", b"\0\0\0\0" + b"".join(icns_rle_plane(
                np.ascontiguousarray(rgb[100:228, 50:178, k] // 8 * 8).tobytes()) for k in range(3))),
            (b"t8mk", alpha(128).tobytes()),
            (b"icp5", encode_png(rgb[0:32, 0:32]))]),
        "icon_png.icns": icns_file([(b"ic07", encode_png(rgb[60:188, 150:278])),
                                    (b"is32", rgb[0:16, 0:16].tobytes())]),
    }
    paths = []
    for name, data in files.items():
        paths.append(os.path.join(td, name))
        with open(paths[-1], "wb") as fh:
            fh.write(data)
    return paths


def codec_files(td: str, img1, img2) -> dict[str, list[str]]:
    """Phase 8 (l)'s pairs: phase 3's as LZMA TIFFs (write_tiff "lzma")
    and as headerless DIBs (write_bmp dib), BASELINE #3's views (tint) as
    PNGs whose only EXIF is a "Raw profile type exif" zTXt chunk after
    the image data (write_png_text_exif, 43 mm), and the committed zstd
    TIFFs of the same views."""
    views, _, _, _ = render_perspective(PERSP_W, PERSP_H, PERSP_CAMS[:1], exact_focal=True)
    files: dict[str, list[str]] = {"lzma tiff": [], "dib": [], "text exif png": [],
                                   "zstd tiff": list(PERSP_ZSTD_TIFFS)}
    for k, (img, view) in enumerate(zip((img1, img2), views)):
        base = os.path.join(td, f"codec_{k}")
        files["lzma tiff"].append(base + "_lzma.tif")
        write_tiff(files["lzma tiff"][-1], img, None, "lzma")
        files["dib"].append(base + ".dib")
        write_bmp(files["dib"][-1], img, dib=True)
        files["text exif png"].append(base + "_text_exif.png")
        write_png_text_exif(files["text exif png"][-1], tint(view), PERSP_FOCAL_35MM)
    return files


def cli_codecs_icons(cap, smi: str, td: str, img1, img2) -> dict:
    """Phase 8 (l), with every import of Pillow blocked (_NoPillow):
    codec_files' pairs through cli.main. The LZMA TIFFs -> PLY and the
    DIBs -> PNG depth map (--interpolation=none), each equal to
    reconstruct's on the arrays; the zstd TIFFs -> OBJ with
    --focal-length=43 and the text-EXIF PNGs -> OBJ with no
    --focal-length (the 43 mm K from the zTXt profile), each with
    cli_exif_jpeg_pair's gates. Then icon_files, decoded only. Every
    plane has the committed SHA-256 of Pillow's ("codecs", "icons"); the
    LZMA, DIB and PNG planes are the arrays."""
    from cybervision_tpu_torch.config import (
        InterpolationMode, MeshMode, ProjectionMode, ReconstructionConfig,
    )
    from cybervision_tpu_torch.images import SourceImage, read_metadata
    from cybervision_tpu_torch.reconstruction import reconstruct

    lzma_ok = importlib.util.find_spec("lzma") is not None
    if lzma_ok:
        try:
            import lzma  # noqa: F401 - the module may exist without its _lzma
        except ImportError:
            lzma_ok = False
    print(f"(l) Python's lzma module imports on this machine: {lzma_ok}")
    if not lzma_ok:
        raise AssertionError("(l): Python's lzma module does not import: LZMA TIFF cannot be read")
    with open(FORMATS_SHA256) as fh:
        committed = json.load(fh)
    t0 = time.perf_counter()
    files = codec_files(td, img1, img2)
    icons = icon_files(td)
    written = time.perf_counter() - t0
    views, _, _, _ = render_perspective(PERSP_W, PERSP_H, PERSP_CAMS[:1], exact_focal=True)
    aff = ProjectionMode.AFFINE
    plain = [SourceImage(im) for im in (img1, img2)]
    records = {}
    with _NoPillow():
        srcs, hashes = {}, {}
        for kind, paths in files.items():
            srcs[kind] = [SourceImage.load(p) for p in paths]
            hashes[kind] = all(
                _plane_sha(s.img) == committed["codecs"][os.path.basename(p)]["l"]
                and _plane_sha(s.load_rgb_plane()) == committed["codecs"][os.path.basename(p)]["rgb"]
                for s, p in zip(srcs[kind], paths))
        lossless = all(np.array_equal(s.img, im) for kind in ("lzma tiff", "dib")
                       for s, im in zip(srcs[kind], (img1, img2)))
        lossless &= all(np.array_equal(s.load_rgb_plane(), tint(v))
                        for s, v in zip(srcs["text exif png"], views))
        focal = [read_metadata(p).focal_length_35mm for p in files["text exif png"]]
        print(f"(l) files written in {written:.2f} s"
              f" ({[os.path.getsize(p) for ps in files.values() for p in ps]} bytes); planes equal"
              f" to Pillow's (SHA-256) {hashes}; LZMA, DIB and PNG planes equal to the arrays"
              f" {lossless}; the text-EXIF PNGs' focal lengths {focal}")
        if not all(hashes.values()) or not lossless or focal != [PERSP_FOCAL_35MM] * 2:
            raise AssertionError("(l): the decoded planes are not Pillow's, or the PNG text"
                                 " profile's focal length was not read")

        label = f"(l) LZMA TIFF pair {SIZE}x{SIZE} -> PLY"
        ref_ply, out = os.path.join(td, "mem_l.ply"), os.path.join(td, "lzma.ply")
        reconstruct(["a", "b"], ref_ply, ReconstructionConfig(
            projection=aff, mesh=MeshMode.VERTEX_COLORS), quiet=True, images=plain)
        run = cap.main(["--projection=parallel", "--mesh=vertex-colors", *files["lzma tiff"], out])
        records["lzma tiff ply"] = cli_record("(l) LZMA TIFF", run["seconds"], run["rec"].phases,
                                              run["decode"], run["launches"], smi)
        same = _sha(out) == _sha(ref_ply)
        print(f"{label}: PLY equal to the in-memory run's {same}")
        if not same:
            raise AssertionError(f"{label}: the PLY differs from the in-memory run's")

        records["zstd tiff obj"] = cli_exif_jpeg_pair(
            cap, smi, td, "(l) zstd TIFF pair", f"(l) zstd TIFF pair {PERSP_W}x{PERSP_H} -> OBJ",
            files["zstd tiff"], srcs["zstd tiff"], {}, (PERSP_W, PERSP_H),
            focal_arg=PERSP_FOCAL_35MM)
        records["text exif png obj"] = cli_exif_jpeg_pair(
            cap, smi, td, "(l) text-EXIF PNG pair",
            f"(l) PNG pair with a zTXt EXIF profile {PERSP_W}x{PERSP_H} -> OBJ",
            files["text exif png"], srcs["text exif png"], {}, (PERSP_W, PERSP_H))

        label = f"(l) DIB pair {SIZE}x{SIZE} -> PNG depth map"
        ref_png, out = os.path.join(td, "mem_l.png"), os.path.join(td, "dib.png")
        reconstruct(["a", "b"], ref_png, ReconstructionConfig(
            projection=aff, interpolation=InterpolationMode.NONE), quiet=True, images=plain)
        run = cap.main(["--projection=parallel", "--interpolation=none", *files["dib"], out])
        records["dib png"] = cli_record("(l) DIB", run["seconds"], run["rec"].phases,
                                        run["decode"], run["launches"], smi, run["encode"])
        same = _sha(out) == _sha(ref_png)
        print(f"{label}: PNG equal to the in-memory run's {same}")
        if not same:
            raise AssertionError(f"{label}: the PNG differs from the in-memory run's")

        decode = {}
        for p in icons:
            t0 = time.perf_counter()
            s = SourceImage.load(p)
            rgb_plane = s.load_rgb_plane()
            decode[os.path.basename(p)] = time.perf_counter() - t0
            hashes[os.path.basename(p)] = (
                _plane_sha(s.img) == committed["icons"][os.path.basename(p)]["l"]
                and _plane_sha(rgb_plane) == committed["icons"][os.path.basename(p)]["rgb"])
        icon_ok = {k: hashes[k] for k in decode}
        print(f"(l) icons {[os.path.getsize(p) for p in icons]} bytes: planes equal to Pillow's"
              f" (SHA-256) {icon_ok}; decode seconds {json.dumps({k: round(v, 4) for k, v in decode.items()})}")
        if not all(icon_ok.values()):
            raise AssertionError("(l): the icons' planes are not Pillow's")
        pil = any(m == "PIL" or m.startswith("PIL.") for m in sys.modules)
    print(f"(l) Pillow imported during the runs {pil}")
    if pil:
        raise AssertionError("(l): Pillow was imported")
    return records


def sun_rle(stream: bytes) -> bytes:
    """A byte stream in Sun raster's byte encoding (file type 2), as one
    run across rows: runs of 3-256 equal bytes, and of 2-256 0x80 bytes, as
    0x80 (n - 1) value; a lone 0x80 as 0x80 0x00; other bytes as
    themselves."""
    a = np.frombuffer(stream, np.uint8)
    starts = np.flatnonzero(np.r_[True, a[1:] != a[:-1]])
    lengths = np.diff(np.r_[starts, len(a)])
    chunks = -(-lengths // 256)
    values = np.repeat(a[starts], chunks)
    n = np.repeat(lengths, chunks) - 256 * (np.arange(chunks.sum())
                                            - np.repeat(np.cumsum(chunks) - chunks, chunks))
    n = np.minimum(n, 256)
    run = (n >= 3) | ((values == 0x80) & (n >= 2))
    lone = (values == 0x80) & (n == 1)
    size = np.where(run, 3, np.where(lone, 2, n))
    at = np.cumsum(size) - size
    out = np.zeros(int(size.sum()), np.uint8)
    out[at[run]], out[at[run] + 1], out[at[run] + 2] = 0x80, n[run] - 1, values[run]
    out[at[lone]], out[at[lone] + 1] = 0x80, 0
    lit = ~run & ~lone
    out[at[lit]] = values[lit]
    two = lit & (n == 2)
    out[at[two] + 1] = values[two]
    return out.tobytes()


def sun_raster(px: np.ndarray, depth: int, file_type: int = 1,
               colour_map: np.ndarray | None = None) -> bytes:
    """A Sun raster of `px`: (H, W) 0/1 bits at depth 1 (set bits black),
    (H, W) 4-bit or 8-bit values, (H, W, 3) RGB at depth 24 or 32 (stored
    BGR(X), or RGB(X) at file type 3); rows padded to 16 bits, or, at file
    type 2, byte-encoded (sun_rle) rows of (W * depth + 7) // 8 bytes, as
    Pillow reads them. colour_map: (n, 3) uint8, stored planar."""
    h, w = px.shape[:2]
    if depth == 1:
        rows = np.packbits(px.astype(np.uint8), axis=1)
    elif depth == 4:
        q = np.pad(px.astype(np.uint8), ((0, 0), (0, w % 2)))
        rows = q[:, 0::2] << 4 | q[:, 1::2]
    elif depth == 8:
        rows = px.astype(np.uint8)
    else:
        c = px if file_type == 3 else px[:, :, ::-1]
        if depth == 32:
            c = np.concatenate([c, np.zeros((h, w, 1), np.uint8)], axis=2)
        rows = np.ascontiguousarray(c, np.uint8).reshape(h, -1)
    if file_type == 2:
        data = sun_rle(np.ascontiguousarray(rows).tobytes())
    else:
        stride = (w * depth + 15) // 16 * 2
        data = np.pad(rows, ((0, 0), (0, stride - rows.shape[1]))).tobytes()
    cmap = b"" if colour_map is None else np.ascontiguousarray(colour_map.T, np.uint8).tobytes()
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(data), file_type,
                       int(colour_map is not None), len(cmap)) + cmap + data


def im_file(px: np.ndarray, image_type: str, lut: np.ndarray | None = None) -> bytes:
    """An IM file as Pillow's ImImagePlugin writes one: "Image type",
    "Image size (x*y)" and "File size (no of images)" lines (and "Lut: 1"
    with a (256, 3) colour table, stored planar), NULs to byte 511, ^Z,
    then the rows of `px` (H, W[, C]) bottom-up, line-interleaved where C
    is given ("RGB", "RGBA", ...), each sample as its dtype's bytes."""
    h, w = px.shape[:2]
    head = f"Image type: {image_type} image\r\nImage size (x*y): {w}*{h}\r\n" \
           "File size (no of images): 1\r\n"
    if lut is not None:
        head += "Lut: 1\r\n"
    data = head.encode().ljust(511, b"\0") + b"\x1a"
    if lut is not None:
        data += np.ascontiguousarray(lut.T, np.uint8).tobytes()
    rows = px[::-1]
    if px.ndim == 3:
        rows = rows.transpose(0, 2, 1)
    return data + np.ascontiguousarray(rows).tobytes()


def msp_file(bits: np.ndarray, version: int = 1) -> bytes:
    """A Windows Paint file of (H, W) 0/1 bits (set bits white): version 1
    raw rows, or version 2 a row map and rows coded as runs of 3-255
    equal bytes (0, count, value) and literals of up to 255 bytes."""
    h, w = bits.shape
    rows = np.packbits(bits.astype(np.uint8), axis=1)
    words = [0] * 16
    words[0], words[1] = struct.unpack("<2H", b"DanM" if version == 1 else b"LinS")
    words[2], words[3], words[4:8], words[8], words[9] = w, h, (1, 1, 1, 1), w, h
    for k in range(12):
        words[12] ^= words[k]
    head = struct.pack("<16H", *words)
    if version == 1:
        return head + rows.tobytes()
    coded = []
    for row in rows:
        out, i, n = bytearray(), 0, len(row)
        while i < n:
            k = 1
            while i + k < n and k < 255 and row[i + k] == row[i]:
                k += 1
            if k >= 3:
                out += bytes([0, k, row[i]])
            else:
                k = 1
                while i + k < n and k < 255 and not (i + k + 2 < n and row[i + k] == row[i + k + 1]
                                                     == row[i + k + 2]):
                    k += 1
                out += bytes([k]) + row[i : i + k].tobytes()
            i += k
        coded.append(bytes(out))
    return head + struct.pack(f"<{h}H", *map(len, coded)) + b"".join(coded)


def xbm_file(bits: np.ndarray, name: str = "im", hotspot=None) -> bytes:
    """An X11 bitmap of (H, W) 0/1 bits (set bits white, as Pillow reads
    them): the #define lines, then the rows' bytes, least significant bit
    first, as 0x.. C literals, 12 a line."""
    h, w = bits.shape
    rows = np.packbits(bits.astype(np.uint8), axis=1, bitorder="little").ravel()
    out = f"#define {name}_width {w}\n#define {name}_height {h}\n"
    if hotspot:
        out += f"#define {name}_x_hot {hotspot[0]}\n#define {name}_y_hot {hotspot[1]}\n"
    out += f"static char {name}_bits[] = {{\n"
    hexes = [f"0x{v:02x}" for v in rows]
    out += ",\n".join(", ".join(hexes[k : k + 12]) for k in range(0, len(hexes), 12))
    return (out + "\n};\n").encode()


def xpm_file(idx: np.ndarray, colours: np.ndarray, cpp: int) -> bytes:
    """An X11 pixmap of (H, W) indices into (n, 3) uint8 colours, each key
    `cpp` characters from an alphabet of 64, as a C string array."""
    h, w = idx.shape
    alphabet = np.frombuffer(b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+-",
                             np.uint8)
    n = len(colours)
    digits = np.stack([alphabet[(np.arange(n) // 64**k) % 64] for k in range(cpp)], axis=1)
    keys = [bytes(d) for d in digits]
    lines = [b"/* XPM */", b"static char *image[] = {", b'"%d %d %d %d",' % (w, h, n, cpp)]
    lines += [b'"%s c #%02x%02x%02x",' % (k, *c) for k, c in zip(keys, colours.tolist())]
    lines.append(b"/* pixels */")
    table = digits[idx]  # (h, w, cpp)
    lines += [b'"' + row.tobytes() + b'",' for row in table]
    lines[-1] = lines[-1][:-1]
    return b"\n".join(lines + [b"};", b""])


def quantised(rgb: np.ndarray, levels: int) -> tuple[np.ndarray, np.ndarray]:
    """(indices (H, W), colours (n, 3) uint8): `rgb` cut to `levels` steps
    a channel, the colours that occur, in order of first value."""
    step = 256 // levels
    q = (rgb // step * step + step // 2).astype(np.uint8)
    colours, idx = np.unique(q.reshape(-1, 3), axis=0, return_inverse=True)
    return idx.reshape(rgb.shape[:2]), colours


def legacy_files(td: str, img1, img2) -> dict[str, list[str]]:
    """Phase 8 (m)'s inputs: phase 3's pair as byte-encoded 8-bit Sun
    rasters (file type 2, as ImageMagick, GIMP and netpbm write .ras),
    BASELINE #3's views (tint) as IM "RGB" files (line-interleaved planes,
    as Pillow saves RGB); and, decoded only, the first view as MSP version
    1 and 2 and XBM (its gray at 128 and up as set bits), as XPMs of 216
    colours ("P") and of 512 ("RGB"), as Sun rasters of 1 bit (raw), 4
    bits with a 16-entry colour map (raw) and 32 bits (byte-encoded), and
    as IM "L 32F" (the gray plus a seeded fraction) and "P" with a colour
    Lut. tests/gen_torch_formats_fixture.py writes the same files and
    commits the SHA-256 of Pillow's planes of them ("legacy")."""
    rng = np.random.RandomState(64)
    views, _, _, _ = render_perspective(PERSP_W, PERSP_H, PERSP_CAMS[:1], exact_focal=True)
    files: dict[str, list[str]] = {"sun rle": [], "im rgb": [], "decode only": []}
    blobs = {}
    for k, (img, view) in enumerate(zip((img1, img2), views)):
        blobs[("sun rle", f"legacy_{k}.ras")] = sun_raster(img, 8, 2)
        blobs[("im rgb", f"legacy_{k}.im")] = im_file(tint(view), "RGB")
    rgb = tint(views[0])
    gray = (rgb.astype(np.uint32) @ np.array([19595, 38470, 7471]) + 0x8000 >> 16).astype(np.uint8)
    bits = gray >= 128
    idx216, pal216 = quantised(rgb, 6)
    idx512, pal512 = quantised(rgb, 8)
    ramp = np.stack([np.arange(16) * 17, 255 - np.arange(16) * 17, np.arange(16) * 8], 1)
    lut = np.zeros((256, 3), np.uint8)
    lut[: len(pal216)] = pal216
    frac = rng.uniform(0, 0.99, gray.shape).astype(np.float32)
    for name, data in (
            ("legacy_v1.msp", msp_file(bits, 1)), ("legacy_v2.msp", msp_file(bits, 2)),
            ("legacy.xbm", xbm_file(bits)), ("legacy_216.xpm", xpm_file(idx216, pal216, 2)),
            ("legacy_512.xpm", xpm_file(idx512, pal512, 2)),
            ("legacy_1bit.ras", sun_raster(bits, 1)),
            ("legacy_4bit.ras", sun_raster(gray >> 4, 4, 1, ramp.astype(np.uint8))),
            ("legacy_32bit.ras", sun_raster(rgb, 32, 2)),
            ("legacy_f.im", im_file((gray + frac).astype("<f4"), "L 32F")),
            ("legacy_p.im", im_file(idx216.astype(np.uint8), "Greyscale", lut))):
        blobs[("decode only", name)] = data
    for (kind, name), data in blobs.items():
        files[kind].append(os.path.join(td, name))
        with open(files[kind][-1], "wb") as fh:
            fh.write(data)
    return files


def cli_legacy_rasters(cap, smi: str, td: str, img1, img2) -> dict:
    """Phase 8 (m), with every import of Pillow blocked (_NoPillow):
    legacy_files' pairs through cli.main. The Sun rasters -> PLY, equal to
    reconstruct's on the arrays; the IM files -> OBJ with
    --focal-length=43 (IM carries no EXIF), with cli_exif_jpeg_pair's
    gates. Then the decode-only files, each plane timed. Every plane has
    the committed SHA-256 of Pillow's ("legacy"); the Sun planes are the
    arrays. Last, the committed damaged LZMA TIFF (LZMA_DAMAGED_TIFF: a
    strip liblzma fills before it finds the damage, which Pillow's libtiff
    reads) decodes to its committed plane ("lzma damaged"), and the
    liblzma that ctypes loaded is printed."""
    from cybervision_tpu_torch.config import MeshMode, ProjectionMode, ReconstructionConfig
    from cybervision_tpu_torch.images import SourceImage
    from cybervision_tpu_torch.imageio import liblzma
    from cybervision_tpu_torch.reconstruction import reconstruct

    with open(FORMATS_SHA256) as fh:
        committed = json.load(fh)
    t_phase = t0 = time.perf_counter()
    files = legacy_files(td, img1, img2)
    written = time.perf_counter() - t0
    records = {}

    def same_as_pillow(src, path, rgb_plane=None):
        want = committed["legacy"][os.path.basename(path)]
        rgb_plane = src.load_rgb_plane() if rgb_plane is None else rgb_plane
        return _plane_sha(src.img) == want["l"] and _plane_sha(rgb_plane) == want["rgb"]

    with _NoPillow():
        srcs = {kind: [SourceImage.load(p) for p in files[kind]] for kind in ("sun rle", "im rgb")}
        hashes = {kind: all(same_as_pillow(s, p) for s, p in zip(srcs[kind], files[kind]))
                  for kind in srcs}
        lossless = all(np.array_equal(s.img, im) for s, im in zip(srcs["sun rle"], (img1, img2)))
        print(f"(m) files written in {written:.2f} s"
              f" ({[os.path.getsize(p) for ps in files.values() for p in ps]} bytes); planes equal"
              f" to Pillow's (SHA-256) {hashes}; Sun gray planes equal to the arrays {lossless}")
        if not all(hashes.values()) or not lossless:
            raise AssertionError("(m): the decoded planes are not Pillow's")

        label = f"(m) byte-encoded Sun raster pair {SIZE}x{SIZE} -> PLY"
        ref_ply, out = os.path.join(td, "mem_m.ply"), os.path.join(td, "sun.ply")
        reconstruct(["a", "b"], ref_ply, ReconstructionConfig(
            projection=ProjectionMode.AFFINE, mesh=MeshMode.VERTEX_COLORS), quiet=True,
            images=[SourceImage(im) for im in (img1, img2)])
        run = cap.main(["--projection=parallel", "--mesh=vertex-colors", *files["sun rle"], out])
        records["sun ply"] = cli_record("(m) Sun raster", run["seconds"], run["rec"].phases,
                                        run["decode"], run["launches"], smi)
        same = _sha(out) == _sha(ref_ply)
        print(f"{label}: PLY equal to the in-memory run's {same}")
        if not same:
            raise AssertionError(f"{label}: the PLY differs from the in-memory run's")

        records["im obj"] = cli_exif_jpeg_pair(
            cap, smi, td, "(m) IM pair", f"(m) IM RGB pair {PERSP_W}x{PERSP_H} -> OBJ",
            files["im rgb"], srcs["im rgb"], {}, (PERSP_W, PERSP_H), focal_arg=PERSP_FOCAL_35MM)

        decode, ok = {}, {}
        for p in files["decode only"] + [LZMA_DAMAGED_TIFF]:
            t0 = time.perf_counter()
            s = SourceImage.load(p)
            rgb_plane = s.load_rgb_plane()
            decode[os.path.basename(p)] = time.perf_counter() - t0
            if p == LZMA_DAMAGED_TIFF:
                want = committed["lzma damaged"]
                ok[os.path.basename(p)] = (_plane_sha(s.img) == want["l"]
                                           and _plane_sha(rgb_plane) == want["rgb"])
            else:
                ok[os.path.basename(p)] = same_as_pillow(s, p, rgb_plane)
        path, version = liblzma.library()
        print(f"(m) decoded only: planes equal to Pillow's (SHA-256) {ok}; decode seconds"
              f" {json.dumps({k: round(v, 4) for k, v in decode.items()})}; liblzma loaded"
              f" through ctypes: {path} (version {version})")
        if not all(ok.values()):
            raise AssertionError("(m): the decode-only planes are not Pillow's")
        pil = any(m == "PIL" or m.startswith("PIL.") for m in sys.modules)
    print(f"(m) Pillow imported during the runs {pil}; (m) took"
          f" {time.perf_counter() - t_phase:.1f} s")
    if pil:
        raise AssertionError("(m): Pillow was imported")
    return records


# Phase 8 (n)'s writers: arithmetic-coded and lossless JPEG, which neither
# Pillow nor the port's encoder writes (tests/test_torch_jpeg_codings.py
# uses them too). Plain Python and numpy.

JPEG_NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])
# T.81 table D.2 (libjpeg's jaricom.c): Qe, next state after an LPS, after
# an MPS, whether an LPS switches the MPS sense. State 113 is the fixed
# 0.5 estimate of signs and refinement bits.
ARITH_STATES = (
    (0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080B, 18, 4, 0),
    (0x03D8, 20, 5, 0), (0x01DA, 23, 6, 0), (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001A, 33, 10, 0), (0x000D, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1), (0x3F25, 36, 16, 0),
    (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0), (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0CEF, 43, 21, 0), (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01B1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0), (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004E, 63, 34, 0), (0x003B, 32, 35, 0), (0x002C, 33, 9, 0),
    (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0), (0x2EF1, 67, 40, 0),
    (0x261F, 68, 41, 0), (0x1F33, 69, 42, 0), (0x19A8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0E74, 74, 46, 0), (0x0BFB, 75, 47, 0), (0x09F8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05CD, 48, 51, 0), (0x04DE, 50, 52, 0),
    (0x040F, 50, 53, 0), (0x0363, 51, 54, 0), (0x02D4, 52, 55, 0), (0x025C, 53, 56, 0),
    (0x01F8, 54, 57, 0), (0x01A4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00F6, 58, 61, 0), (0x00CB, 59, 62, 0), (0x00AB, 61, 63, 0), (0x008F, 61, 32, 0),
    (0x5B12, 65, 65, 1), (0x4D04, 80, 66, 0), (0x412C, 81, 67, 0), (0x37D8, 82, 68, 0),
    (0x2FE8, 83, 69, 0), (0x293C, 84, 70, 0), (0x2379, 86, 71, 0), (0x1EDF, 87, 72, 0),
    (0x1AA9, 87, 73, 0), (0x174E, 72, 74, 0), (0x1424, 72, 75, 0), (0x119C, 74, 76, 0),
    (0x0F6B, 74, 77, 0), (0x0D51, 75, 78, 0), (0x0BB6, 77, 79, 0), (0x0A40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4D1C, 88, 82, 0), (0x438E, 89, 83, 0), (0x3BDD, 90, 84, 0),
    (0x34EE, 91, 85, 0), (0x2EAE, 92, 86, 0), (0x299A, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4CA9, 95, 90, 0), (0x44D9, 96, 91, 0), (0x3E22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32B4, 99, 94, 0), (0x2E17, 93, 86, 0), (0x56A8, 95, 96, 1),
    (0x4F46, 101, 97, 0), (0x47E5, 102, 98, 0), (0x41CF, 103, 99, 0), (0x3C3D, 104, 100, 0),
    (0x375E, 99, 93, 0), (0x5231, 105, 102, 0), (0x4C0F, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415E, 103, 99, 0), (0x5627, 105, 106, 1), (0x50E7, 108, 107, 0), (0x4B85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504F, 111, 107, 0), (0x5A10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59EB, 112, 111, 1), (0x5A1D, 113, 113, 0),
)
# libjpeg-turbo's jpeg_simple_progression for 3 YCbCr components, and
# for any other count (each entry: components, Ss, Se, Ah, Al).
PROGRESSION_YCC = (
    ((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
    ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1), ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
    ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0))


def simple_progression(ncomp: int) -> tuple:
    if ncomp == 3:
        return PROGRESSION_YCC
    every = tuple(range(ncomp))
    ac = [((c,), 1, 5, 0, 2) for c in every] + [((c,), 6, 63, 0, 2) for c in every] \
        + [((c,), 1, 63, 2, 1) for c in every]
    refine = [((c,), 1, 63, 1, 0) for c in every]
    return ((every, 0, 0, 0, 1), *ac, (every, 0, 0, 1, 0), *refine)


class ArithEncoder:
    """T.81 Annex D's arithmetic (QM) encoder as libjpeg's jcarith.c codes
    it: the C register with its spacer bits, carry over stacked 0xFF
    bytes, and the termination that drops trailing zero bytes."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self) -> None:
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _put(self, byte: int) -> None:
        if self.zc:
            self.out += bytes(self.zc)
            self.zc = 0
        self.out.append(byte)
        if byte == 0xFF:
            self.out.append(0)

    def _flush_stack(self) -> None:
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._put(self.buffer)
        if self.sc:
            if self.zc:
                self.out += bytes(self.zc)
                self.zc = 0
            self.out += b"\xff\x00" * self.sc
            self.sc = 0

    def _carry(self) -> None:
        if self.buffer >= 0:
            self._put(self.buffer + 1)
        self.zc += self.sc
        self.sc = 0

    def encode(self, st: bytearray, i: int, val: int) -> None:
        sv = st[i]
        qe, nl, nm, switch = ARITH_STATES[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ (nl | switch << 7)
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    self._carry()
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._flush_stack()
                    self.buffer = temp
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                return

    def finish(self) -> None:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            self._carry()
        else:
            self._flush_stack()
        if self.c & 0x7FFF800:
            self._put((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._put((self.c >> 11) & 0xFF)
        self.zc = 0


def _arith_dc(enc: ArithEncoder, st: bytearray, ctx: int, diff: int, lo: int, hi: int) -> int:
    """One DC difference (F.1.4.1, F.1.4.4.1); the component's next
    conditioning index."""
    if diff == 0:
        enc.encode(st, ctx, 0)
        return 0
    enc.encode(st, ctx, 1)
    if diff > 0:
        enc.encode(st, ctx + 1, 0)
        i, ctx = ctx + 2, 4
    else:
        diff = -diff
        enc.encode(st, ctx + 1, 1)
        i, ctx = ctx + 3, 8
    m, v = 0, diff - 1
    if v:
        enc.encode(st, i, 1)
        m, v2, i = 1, v >> 1, 20
        while v2:
            enc.encode(st, i, 1)
            m, v2, i = m << 1, v2 >> 1, i + 1
    enc.encode(st, i, 0)
    if m < (1 << lo) >> 1:
        ctx = 0
    elif m > (1 << hi) >> 1:
        ctx += 8
    i += 14
    m >>= 1
    while m:
        enc.encode(st, i, 1 if m & v else 0)
        m >>= 1
    return ctx


def _arith_ac(enc: ArithEncoder, st: bytearray, fixed: bytearray, t: list, ss: int, se: int,
              kx: int) -> None:
    """The band ss..se of one block's (point-transformed) zigzag values
    (F.1.4.2, G.1.3.2)."""
    ke = se
    while ke >= ss and t[ke] == 0:
        ke -= 1
    k = ss
    while k <= ke:
        i = 3 * (k - 1)
        enc.encode(st, i, 0)
        while t[k] == 0:
            enc.encode(st, i + 1, 0)
            i, k = i + 3, k + 1
        enc.encode(st, i + 1, 1)
        v = t[k]
        enc.encode(fixed, 0, int(v < 0))
        v = abs(v) - 1
        i += 2
        m = 0
        if v:
            enc.encode(st, i, 1)
            m, v2 = 1, v >> 1
            if v2:
                enc.encode(st, i, 1)
                m, v2, i = 2, v2 >> 1, (189 if k <= kx else 217)
                while v2:
                    enc.encode(st, i, 1)
                    m, v2, i = m << 1, v2 >> 1, i + 1
        enc.encode(st, i, 0)
        i += 14
        m >>= 1
        while m:
            enc.encode(st, i, 1 if m & v else 0)
            m >>= 1
        k += 1
    if k <= se:
        enc.encode(st, 3 * (k - 1), 1)


def _arith_ac_refine(enc: ArithEncoder, st: bytearray, fixed: bytearray, c: list, ss: int,
                     se: int, ah: int, al: int) -> None:
    """G.1.3.3: the bit al of the band's coefficients (zigzag values)."""
    ke = se
    while ke > 0 and abs(c[ke]) >> al == 0:
        ke -= 1
    kex = ke
    while kex > 0 and abs(c[kex]) >> ah == 0:
        kex -= 1
    k = ss
    while k <= ke:
        i = 3 * (k - 1)
        if k > kex:
            enc.encode(st, i, 0)
        while True:
            v = abs(c[k]) >> al
            if v:
                if v >> 1:
                    enc.encode(st, i + 2, v & 1)
                else:
                    enc.encode(st, i + 1, 1)
                    enc.encode(fixed, 0, int(c[k] < 0))
                break
            enc.encode(st, i + 1, 0)
            i, k = i + 3, k + 1
        k += 1
    if k <= se:
        enc.encode(st, 3 * (k - 1), 1)


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _mcu_blocks(sampling, members, width, height):
    """Each MCU's blocks of a scan over `members` (component indices) as
    (member, row, column) lists: the MCU grid of the frame for an
    interleaved scan, the component's own block grid for one."""
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    if len(members) == 1:
        c = members[0]
        dw, dh = -(-width * sampling[c][0] // hmax), -(-height * sampling[c][1] // vmax)
        bw, bh = -(-dw // 8), -(-dh // 8)
        return [[(0, r, x)] for r in range(bh) for x in range(bw)]
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    out = []
    for my in range(mcuy):
        for mx in range(mcux):
            out.append([(j, my * sampling[c][1] + by, mx * sampling[c][0] + bx)
                        for j, c in enumerate(members)
                        for by in range(sampling[c][1]) for bx in range(sampling[c][0])])
    return out


def arith_jpeg(coefs: list[np.ndarray], quant: np.ndarray, width: int, height: int,
               sampling=None, ids=None, progressive: bool = False, script=None,
               restart: int = 0, dac: dict | None = None, markers: bytes = b"") -> bytes:
    """An arithmetic-coded JPEG (SOF9, or SOF10 when `progressive`) of the
    quantised DCT coefficients `coefs`: per component (rows, cols, 64)
    integers in natural order over its whole MCU grid (the blocks past the
    image's edge are coded in interleaved scans). `quant`: (n, 64) tables
    in natural order, component c using table min(c, 1); `sampling`: (h,
    v) per component (1x1 each by default); `ids`: the component ids (1,
    2, ...); `script`: the scans as (components, Ss, Se, Ah, Al)
    (sequential: one interleaved scan; progressive: simple_progression);
    `restart`: the DRI interval in MCUs; `dac`: {scan index: [(class,
    table, value)]}, a DAC segment before that scan's SOS (class 0: the DC
    table's L | U << 4, 1: the AC table's K); `markers`: segments written
    after SOI (APP0, APP1, APP14). Component c codes with DC/AC table
    min(c, 1), as libjpeg assigns them."""
    n = len(coefs)
    sampling = sampling or [(1, 1)] * n
    ids = ids or list(range(1, n + 1))
    if script is None:
        script = simple_progression(n) if progressive else ((tuple(range(n)), 0, 63, 0, 0),)
    zz = [c.reshape(c.shape[0], c.shape[1], 64)[:, :, JPEG_NATURAL].tolist() for c in coefs]
    tables = sorted({min(c, 1) for c in range(n)})
    out = bytearray(b"\xff\xd8" + markers)
    for t in tables:
        out += _segment(0xDB, bytes([t]) + quant[t][JPEG_NATURAL].astype(np.uint8).tobytes())
    out += _segment(0xCA if progressive else 0xC9, struct.pack(">BHHB", 8, height, width, n) + b"".join(
        bytes([ids[c], sampling[c][0] << 4 | sampling[c][1], min(c, 1)]) for c in range(n)))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    cond_l, cond_u, cond_k = [0] * 16, [1] * 16, [5] * 16
    for s, (members, ss, se, ah, al) in enumerate(script):
        for cls, tb, value in (dac or {}).get(s, []):
            if cls:
                cond_k[tb] = value
            else:
                cond_l[tb], cond_u[tb] = value & 15, value >> 4
        if (dac or {}).get(s):
            out += _segment(0xCC, b"".join(bytes([cls << 4 | tb, value])
                                           for cls, tb, value in dac[s]))
        dc_scan = not progressive or (ss == 0 and ah == 0)
        ac_scan = not progressive or ss > 0
        out += _segment(0xDA, bytes([len(members)]) + b"".join(
            bytes([ids[c], (min(c, 1) << 4 if dc_scan else 0) | (min(c, 1) if ac_scan else 0)])
            for c in members) + bytes([ss, se, ah << 4 | al]))
        enc = ArithEncoder()
        fixed = bytearray([113])
        mcus = _mcu_blocks(sampling, members, width, height)

        def reset():
            stats = ({t: bytearray(64) for t in tables}, {t: bytearray(256) for t in tables})
            return stats, [0] * len(members), [0] * len(members)

        (dc_st, ac_st), last, ctx = reset()
        for m, blocks in enumerate(mcus):
            if restart and m and m % restart == 0:
                enc.finish()
                enc.out += bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
                enc.reset()
                (dc_st, ac_st), last, ctx = reset()
            for j, r, x in blocks:
                c = members[j]
                t = min(c, 1)
                blk = zz[c][r][x]
                if not progressive or (ss == 0 and ah == 0):
                    dc = blk[0] >> al
                    ctx[j] = _arith_dc(enc, dc_st[t], ctx[j], dc - last[j], cond_l[t], cond_u[t])
                    last[j] = dc
                    if not progressive:
                        _arith_ac(enc, ac_st[t], fixed, blk, 1, 63, cond_k[t])
                elif ss == 0:
                    enc.encode(fixed, 0, (blk[0] >> al) & 1)
                elif ah == 0:
                    band = [0] * ss + [(v >> al if v >= 0 else -(-v >> al)) for v in blk[ss : se + 1]]
                    _arith_ac(enc, ac_st[t], fixed, band, ss, se, cond_k[t])
                else:
                    _arith_ac_refine(enc, ac_st[t], fixed, blk, ss, se, ah, al)
        enc.finish()
        out += enc.out
    return bytes(out + b"\xff\xd9")


def dct_coefficients(planes: list[np.ndarray], quant: np.ndarray, sampling, width: int,
                     height: int) -> list[np.ndarray]:
    """Quantised DCT coefficients (rows, cols, 64), natural order, of each
    plane (uint8, already at its component's resolution) over its whole
    MCU grid: edge samples repeated to the grid, a DCT in integers (the
    basis scaled by 2^13 and rounded, so that every machine computes the
    same file), each coefficient rounded to the nearest multiple of the
    component's table (min(c, 1))."""
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    x = np.arange(8)
    basis = np.cos((2 * x[None, :] + 1) * x[:, None] * np.pi / 16) / 2
    basis[0] /= np.sqrt(2)
    basis = np.round(basis * (1 << 13)).astype(np.int64)
    out = []
    for c, p in enumerate(planes):
        h, v = sampling[c]
        rows, cols = mcuy * v * 8, mcux * h * 8
        full = np.pad(p.astype(np.int64), ((0, rows - p.shape[0]), (0, cols - p.shape[1])),
                      mode="edge") - 128
        blocks = full.reshape(rows // 8, 8, cols // 8, 8).transpose(0, 2, 1, 3)
        d = np.einsum("ux,abxy,vy->abuv", basis, blocks, basis)  # exact in int64
        q = quant[min(c, 1)].reshape(8, 8).astype(np.int64) << 26
        out.append(((2 * d + q) // (2 * q)).reshape(rows // 8, cols // 8, 64))
    return out


def ycbcr_planes(rgb: np.ndarray, sampling) -> list[np.ndarray]:
    """Y, Cb, Cr of (H, W, 3) RGB in jccolor.c's fixed point (16 bits),
    each averaged down to its component's resolution (the mean of
    hmax/h x vmax/v samples, edge samples repeated, rounded half up)."""
    f = rgb.astype(np.int64)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    half = 1 << 15
    planes = [(19595 * r + 38470 * g + 7471 * b + half) >> 16,
              (-11059 * r - 21709 * g + 32768 * b + (128 << 16) + half - 1) >> 16,
              (32768 * r - 27439 * g - 5329 * b + (128 << 16) + half - 1) >> 16]
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    out = []
    for c, p in enumerate(planes):
        fx, fy = hmax // sampling[c][0], vmax // sampling[c][1]
        hh, ww = -(-p.shape[0] // fy) * fy, -(-p.shape[1] // fx) * fx
        p = np.pad(p, ((0, hh - p.shape[0]), (0, ww - p.shape[1])), mode="edge")
        total = p.reshape(hh // fy, fy, ww // fx, fx).sum(axis=(1, 3))
        out.append(((2 * total + fx * fy) // (2 * fx * fy)).astype(np.uint8))
    return out


def _huffman_code_lengths(freq: list[int]) -> tuple[list[int], list[int]]:
    """(16 code counts, symbols) of jchuff.c jpeg_gen_optimal_table: a
    Huffman code for the symbols of nonzero `freq` (256 entries), no code
    longer than 16 bits, none all ones."""
    freq = list(freq) + [1]
    size, others = [0] * 257, [-1] * 257
    while True:
        live = [i for i in range(257) if freq[i]]
        c1 = max(live, key=lambda i: (-freq[i], i))
        rest = [i for i in live if i != c1]
        if not rest:
            break
        c2 = max(rest, key=lambda i: (-freq[i], i))
        freq[c1] += freq[c2]
        freq[c2] = 0
        for c in (c1, c2):
            size[c] += 1
            while others[c] >= 0:
                c = others[c]
                size[c] += 1
        c = c1
        while others[c] >= 0:
            c = others[c]
        others[c] = c2
    bits = [0] * 33
    for s in size:
        if s:
            bits[s] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1
    symbols = [s for length in range(1, 33) for s in range(256) if size[s] == length]
    return bits[1:17], symbols


def _huffman_codes(counts: list[int], symbols: list[int]) -> dict[int, tuple[int, int]]:
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes[symbols[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return codes


# T.81 table K.3, the luminance DC code lengths, with the categories past
# 11 that 8-bit lossless differences need (up to 16) given 16-bit codes.
LOSSLESS_STD_HUFF = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 5], list(range(17)))


def _pack_bits(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """MSB-first bits of `values` (each `lengths` bits), padded with 1
    bits to a byte, 0xFF bytes stuffed with 0x00."""
    lengths = lengths.astype(np.int64)
    total = int(lengths.sum())
    starts = np.cumsum(lengths) - lengths
    within = np.arange(total) - np.repeat(starts, lengths)
    bits = (np.repeat(values.astype(np.int64), lengths)
            >> (np.repeat(lengths, lengths) - 1 - within)) & 1
    bits = np.concatenate([bits, np.ones(-total % 8, np.int64)]).astype(np.uint8)
    return np.packbits(bits).tobytes().replace(b"\xff", b"\xff\x00")


def lossless_jpeg(planes: list[np.ndarray], predictor: int = 1, pt: int = 0,
                  restart_rows: int = 0, interleaved: bool = True, optimal: bool = True,
                  ids=None, markers: bytes = b"", sampling=None) -> bytes:
    """A lossless JPEG (SOF3, T.81 Annex H, 8-bit) of `planes` (uint8,
    each at its component's resolution under `sampling`): predictor 1-7,
    point transform `pt`, a restart every `restart_rows` MCU rows (the
    DRI interval is that many rows of MCUs), one interleaved scan or one
    scan per component, Huffman tables optimised per scan (jchuff.c's
    way) or LOSSLESS_STD_HUFF. Component c codes with table min(c, 1)."""
    n = len(planes)
    sampling = sampling or [(1, 1)] * n
    ids = ids or list(range(1, n + 1))
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    height = max(p.shape[0] * vmax // sampling[c][1] for c, p in enumerate(planes))
    width = max(p.shape[1] * hmax // sampling[c][0] for c, p in enumerate(planes))
    out = bytearray(b"\xff\xd8" + markers)
    out += _segment(0xC3, struct.pack(">BHHB", 8, height, width, n) + b"".join(
        bytes([ids[c], sampling[c][0] << 4 | sampling[c][1], 0]) for c in range(n)))
    scans = [tuple(range(n))] if interleaved else [(c,) for c in range(n)]
    for members in scans:
        single = len(members) == 1
        mcu_w = 1 if single else hmax
        mcu_h = 1 if single else vmax
        ref = planes[members[0]]
        mcux = ref.shape[1] if single else -(-width // hmax)
        mcuy = ref.shape[0] if single else -(-height // vmax)
        # Differences of each component over its MCU-padded grid (padded
        # samples repeat the edge, as libjpeg's encoder pads them).
        diffs = []
        for c in members:
            h, v = (1, 1) if single else sampling[c]
            p = planes[c].astype(np.int64) >> pt
            p = np.pad(p, ((0, mcuy * v - p.shape[0]), (0, mcux * h - p.shape[1])), mode="edge")
            ra = np.pad(p, ((0, 0), (1, 0)))[:, :-1]
            rb = np.pad(p, ((1, 0), (0, 0)))[:-1]
            rc = np.pad(p, ((1, 0), (1, 0)))[:-1, :-1]
            pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
                    6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[predictor].copy()
            pred[:, 0] = rb[:, 0]
            first = np.zeros(p.shape[0], bool)
            rows_per = restart_rows * v if restart_rows else p.shape[0]
            first[::rows_per] = True
            pred[first] = ra[first]
            pred[first, 0] = 1 << (7 - pt)
            d = (p - pred) & 0xFFFF
            diffs.append(np.where(d >= 0x8000, d - 0x10000, d))
        # MCU order: each MCU row, each MCU, each member's h x v samples.
        order_vals, order_comp = [], []
        for j, c in enumerate(members):
            h, v = (1, 1) if single else sampling[c]
            d = diffs[j].reshape(mcuy, v, mcux, h).transpose(0, 2, 1, 3).reshape(mcuy, mcux, v * h)
            order_vals.append(d)
            order_comp.append(np.full(d.shape, j))
        vals = np.concatenate(order_vals, axis=2).reshape(mcuy, -1)
        comp = np.concatenate(order_comp, axis=2).reshape(mcuy, -1)
        mag = np.abs(vals)
        cat = np.where(mag == 0, 0, np.floor(np.log2(np.maximum(mag, 1))).astype(np.int64) + 1)
        cat = np.where(vals == -0x8000, 16, cat)
        extra = np.where(vals > 0, vals, vals + (1 << cat) - 1) & ((1 << cat) - 1)
        extra_len = np.where(cat == 16, 0, cat)
        specs = {}
        for t in sorted({min(c, 1) for c in members}):
            mask = np.isin(comp, [j for j, c in enumerate(members) if min(c, 1) == t])
            if optimal:
                freq = np.bincount(cat[mask], minlength=256)[:256].tolist()
                specs[t] = _huffman_code_lengths(freq)
            else:
                specs[t] = LOSSLESS_STD_HUFF
            counts, symbols = specs[t]
            out += _segment(0xC4, bytes([t]) + bytes(counts) + bytes(symbols))
        if restart_rows:
            out += _segment(0xDD, struct.pack(">H", restart_rows * mcux))
        out += _segment(0xDA, bytes([len(members)]) + b"".join(
            bytes([ids[c], min(c, 1) << 4]) for c in members) + bytes([predictor, 0, pt]))
        code_of = {t: _huffman_codes(*spec) for t, spec in specs.items()}
        table_of = np.array([min(c, 1) for c in members])[comp]
        code = np.zeros(cat.shape, np.int64)
        clen = np.zeros(cat.shape, np.int64)
        for t, codes in code_of.items():
            for s, (cv, cl) in codes.items():
                sel = (table_of == t) & (cat == s)
                code[sel], clen[sel] = cv, cl
        rows_per = restart_rows or mcuy
        for k, y in enumerate(range(0, mcuy, rows_per)):
            if k:
                out += bytes([0xFF, 0xD0 + (k - 1) % 8])
            seg = slice(y, y + rows_per)
            v = np.stack([code[seg], extra[seg]], -1).reshape(-1)
            ln = np.stack([clen[seg], extra_len[seg]], -1).reshape(-1)
            out += _pack_bits(v, ln)
    return bytes(out + b"\xff\xd9")


JPEG_CODING_QUALITY = 90  # phase 8 (n)'s DCT files: libjpeg's tables at this quality


def exif_app1(focal: int) -> bytes:
    """An APP1 segment: "Exif\\0\\0" and exif_focal_block(focal)."""
    body = b"Exif\0\0" + exif_focal_block(focal)
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def jpeg_coding_files(td: str, img1, img2) -> dict[str, list[str]]:
    """Phase 8 (n)'s inputs, written by arith_jpeg and lossless_jpeg:
    phase 3's pair as arithmetic-coded sequential JPEGs (the second with a
    restart interval of 128 MCUs) and as lossless ones (predictors 4 and
    7, the second with a restart every 16 rows); BASELINE #3's views
    (tint) as arithmetic-coded progressive 4:2:0 JPEGs with EXIF 41989 =
    43; and, decoded only, the first view as an arithmetic progressive
    file without its refinements to bit 0 (block smoothing), as a
    lossless RGB file with a restart every 8 rows (predictor 5), as an
    arithmetic progressive file with DAC segments before its first and
    sixth scans, and two files Pillow refuses: 12-bit (a lossless file's
    precision rewritten) and arithmetic-coded lossless (SOF11).
    tests/gen_torch_formats_fixture.py writes the same files and commits
    the SHA-256 of Pillow's planes of the ones it reads ("jpeg codings")."""
    from cybervision_tpu_torch.imageio.jpeg_encode import quant_tables

    quant = quant_tables(JPEG_CODING_QUALITY)
    jfif = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    views, _, _, _ = render_perspective(PERSP_W, PERSP_H, PERSP_CAMS[:1], exact_focal=True)
    ycc = [(2, 2), (1, 1), (1, 1)]

    def arith_rgb(rgb, **opts):
        h, w = rgb.shape[:2]
        coefs = dct_coefficients(ycbcr_planes(rgb, ycc), quant, ycc, w, h)
        return arith_jpeg(coefs, quant, w, h, ycc, progressive=True, **opts)

    blobs = {}
    for k, img in enumerate((img1, img2)):
        coefs = dct_coefficients([img], quant, [(1, 1)], img.shape[1], img.shape[0])
        blobs[("arith", f"arith_{k}.jpg")] = arith_jpeg(
            coefs, quant, img.shape[1], img.shape[0], restart=128 * k, markers=jfif)
        blobs[("lossless", f"lossless_{k}.jpg")] = lossless_jpeg([img], (4, 7)[k], 0, 16 * k)
    for k, view in enumerate(views):
        blobs[("arith progressive", f"arith_view_{k}.jpg")] = arith_rgb(
            tint(view), markers=jfif + exif_app1(PERSP_FOCAL_35MM))
    rgb = tint(views[0])
    lossless_rgb = lossless_jpeg([rgb[:, :, c] for c in range(3)], 5, 0, 8)
    twelve = bytearray(lossless_rgb)
    twelve[twelve.find(b"\xff\xc3") + 4] = 12
    sof11 = bytearray(lossless_rgb)
    sof11[sof11.find(b"\xff\xc3") + 1] = 0xCB
    for name, data in (
            ("smoothed.jpg", arith_rgb(rgb, markers=jfif, script=PROGRESSION_YCC[:7])),
            ("lossless_rgb.jpg", lossless_rgb),
            ("dac.jpg", arith_rgb(rgb, markers=jfif, dac={
                0: [(0, 0, 0x31), (0, 1, 0x52)], 5: [(1, 0, 20), (1, 1, 2)]}))):
        blobs[("decode only", name)] = data
    blobs[("refused", "12bit.jpg")] = bytes(twelve)
    blobs[("refused", "sof11.jpg")] = bytes(sof11)
    files: dict[str, list[str]] = {}
    for (kind, name), data in blobs.items():
        files.setdefault(kind, []).append(os.path.join(td, name))
        with open(files[kind][-1], "wb") as fh:
            fh.write(data)
    return files


def cli_jpeg_codings(cap, smi: str, td: str, img1, img2) -> dict:
    """Phase 8 (n), with every import of Pillow blocked (_NoPillow):
    jpeg_coding_files' pairs through cli.main. The arithmetic pair -> PLY,
    equal to reconstruct's on the decoded planes; the arithmetic
    progressive views -> OBJ with no --focal-length (the 43 mm K from
    their EXIF), with cli_exif_jpeg_pair's gates; the lossless pair ->
    PLY, byte-equal to reconstruct's on the arrays (its planes are the
    arrays). Every plane of a file Pillow reads has the committed SHA-256
    of Pillow's ("jpeg codings"; the arithmetic pair's with Pillow's read
    block raised to the file, since Pillow fails on arithmetic data past
    its first 64 KiB); the decode-only files are timed; the 12-bit and
    SOF11 files raise an ImageError without "yet"."""
    from cybervision_tpu_torch.config import MeshMode, ProjectionMode, ReconstructionConfig
    from cybervision_tpu_torch.errors import ImageError
    from cybervision_tpu_torch.images import SourceImage
    from cybervision_tpu_torch.reconstruction import reconstruct

    with open(FORMATS_SHA256) as fh:
        committed = json.load(fh)["jpeg codings"]
    t_phase = t0 = time.perf_counter()
    files = jpeg_coding_files(td, img1, img2)
    written = time.perf_counter() - t0
    records = {}

    def same_as_pillow(src, path, rgb_plane=None):
        want = committed[os.path.basename(path)]
        rgb_plane = src.load_rgb_plane() if rgb_plane is None else rgb_plane
        return _plane_sha(src.img) == want["l"] and _plane_sha(rgb_plane) == want["rgb"]

    with _NoPillow():
        srcs = {kind: [SourceImage.load(p) for p in files[kind]]
                for kind in ("arith", "arith progressive", "lossless")}
        hashes = {kind: all(same_as_pillow(s, p) for s, p in zip(srcs[kind], files[kind]))
                  for kind in ("arith", "arith progressive")}
        exact = all(np.array_equal(s.img, im) for s, im in zip(srcs["lossless"], (img1, img2)))
        print(f"(n) files written in {written:.2f} s"
              f" ({[os.path.getsize(p) for ps in files.values() for p in ps]} bytes); planes equal"
              f" to Pillow's (SHA-256) {hashes}; lossless gray planes equal to the arrays {exact}")
        if not all(hashes.values()) or not exact:
            raise AssertionError("(n): the decoded planes are not Pillow's")

        aff = ReconstructionConfig(projection=ProjectionMode.AFFINE, mesh=MeshMode.VERTEX_COLORS)
        for kind, run_name, arrays in (("arith", "arith ply", [s.img for s in srcs["arith"]]),
                                       ("lossless", "lossless ply", [img1, img2])):
            label = f"(n) {kind} JPEG pair {SIZE}x{SIZE} -> PLY"
            ref_ply, out = os.path.join(td, f"mem_{kind}.ply"), os.path.join(td, f"{kind}.ply")
            reconstruct(["a", "b"], ref_ply, aff, quiet=True,
                        images=[SourceImage(im) for im in arrays])
            run = cap.main(["--projection=parallel", "--mesh=vertex-colors", *files[kind], out])
            records[run_name] = cli_record(f"(n) {kind} JPEG", run["seconds"], run["rec"].phases,
                                           run["decode"], run["launches"], smi)
            same = _sha(out) == _sha(ref_ply)
            print(f"{label}: PLY equal to the in-memory run's"
                  f" ({'the arrays' if kind == 'lossless' else 'the decoded planes'}) {same}")
            if not same:
                raise AssertionError(f"{label}: the PLY differs from the in-memory run's")

        records["arith progressive obj"] = cli_exif_jpeg_pair(
            cap, smi, td, "(n) arithmetic progressive pair",
            f"(n) arithmetic progressive pair {PERSP_W}x{PERSP_H} -> OBJ",
            files["arith progressive"], srcs["arith progressive"],
            {"planes equal to Pillow's (SHA-256)": hashes["arith progressive"]},
            (PERSP_W, PERSP_H))

        decode, ok = {}, {}
        for p in files["decode only"]:
            t0 = time.perf_counter()
            s = SourceImage.load(p)
            rgb_plane = s.load_rgb_plane()
            decode[os.path.basename(p)] = time.perf_counter() - t0
            ok[os.path.basename(p)] = same_as_pillow(s, p, rgb_plane)
        refused = {}
        for p in files["refused"]:
            try:
                SourceImage.load(p).load_rgb_plane()
                refused[os.path.basename(p)] = "read"
            except ImageError as err:
                refused[os.path.basename(p)] = f"{type(err).__name__}: {err}"
        print(f"(n) decoded only: planes equal to Pillow's (SHA-256) {ok}; decode seconds"
              f" {json.dumps({k: round(v, 4) for k, v in decode.items()})}; refused {refused}")
        if not all(ok.values()):
            raise AssertionError("(n): the decode-only planes are not Pillow's")
        if any(r == "read" or "yet" in r for r in refused.values()):
            raise AssertionError("(n): a file Pillow refuses was read, or refused as a gap")
        pil = any(m == "PIL" or m.startswith("PIL.") for m in sys.modules)
    print(f"(n) Pillow imported during the runs {pil}; (n) took"
          f" {time.perf_counter() - t_phase:.1f} s")
    if pil:
        raise AssertionError("(n): Pillow was imported")
    return records


# Phase 8 (o)'s writers: old-style JPEG-in-TIFF, PSD, FITS and the small
# raw formats, which Pillow does not write (tests/test_torch_pillow_rest.py
# uses them too). Plain Python and numpy.


def _scan_entries(coefs: list[np.ndarray], sampling, members, width: int, height: int,
                  restart: int) -> dict:
    """The symbols of one baseline scan over the components `members`, in
    coding order: arrays seg (restart interval), cls (0 DC, 1 AC), tab
    (table min(c, 1)), symbol, extra (bits), extra_n (their count)."""
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    if len(members) == 1:
        c = members[0]
        dw = -(-width * sampling[c][0] // hmax)
        dh = -(-height * sampling[c][1] // vmax)
        bw, bh = -(-dw // 8), -(-dh // 8)
        blocks = coefs[c][:bh, :bw].reshape(-1, 64)
        comp = np.full(len(blocks), c)
        mcu = np.arange(len(blocks))
    else:
        mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
        parts, comps = [], []
        for c in members:
            h, v = sampling[c]
            b = coefs[c][: mcuy * v, : mcux * h].reshape(mcuy, v, mcux, h, 64)
            parts.append(b.transpose(0, 2, 1, 3, 4).reshape(mcuy, mcux, v * h, 64))
            comps.append(np.full((mcuy, mcux, v * h), c))
        blocks = np.concatenate(parts, axis=2).reshape(-1, 64)
        comp = np.concatenate(comps, axis=2).reshape(-1)
        mcu = np.repeat(np.arange(mcux * mcuy), len(comp) // (mcux * mcuy))
    zz = blocks[:, JPEG_NATURAL].astype(np.int64)
    seg = mcu // restart if restart else np.zeros(len(mcu), np.int64)
    diff = np.zeros(len(zz), np.int64)
    for c in members:
        idx = np.flatnonzero(comp == c)
        dc = zz[idx, 0]
        prev = np.r_[0, dc[:-1]]
        prev[np.r_[True, seg[idx][1:] != seg[idx][:-1]]] = 0
        diff[idx] = dc - prev

    def size_bits(v):
        mag = np.abs(v)
        n = np.zeros(v.shape, np.int64)
        nz = mag > 0
        n[nz] = np.floor(np.log2(mag[nz])).astype(np.int64) + 1
        return n, np.where(v >= 0, v, v + (1 << n) - 1) & ((1 << n) - 1)

    dc_n, dc_x = size_bits(diff)
    rows_b, cols_k = np.nonzero(zz[:, 1:])
    cols_k = cols_k + 1
    prev_k = np.r_[0, cols_k[:-1]]
    prev_k[np.r_[True, rows_b[1:] != rows_b[:-1]]] = 0
    run = cols_k - prev_k - 1
    ac_n, ac_x = size_bits(zz[rows_b, cols_k])
    zrl = run // 16
    zrl_b = np.repeat(rows_b, zrl)
    last = np.zeros(len(zz), np.int64)
    last[rows_b] = cols_k  # rows_b ascends: each block's last nonzero coefficient
    eob_b = np.flatnonzero(last < 63)
    n_ac = len(rows_b) + len(zrl_b) + len(eob_b)
    block = np.concatenate([np.arange(len(zz)), rows_b, zrl_b, eob_b])
    key = np.concatenate([np.zeros(len(zz), np.int64), 2 * cols_k,
                          np.repeat(2 * cols_k - 1, zrl), np.full(len(eob_b), 200)])
    order = np.lexsort((key, block))
    block = block[order]
    return {
        "seg": seg[block], "tab": np.minimum(comp, 1)[block],
        "cls": np.concatenate([np.zeros(len(zz), np.int64), np.ones(n_ac, np.int64)])[order],
        "symbol": np.concatenate([dc_n, (run % 16) << 4 | ac_n, np.full(len(zrl_b), 0xF0),
                                  np.zeros(len(eob_b), np.int64)])[order],
        "extra": np.concatenate([dc_x, ac_x, np.zeros(len(zrl_b) + len(eob_b), np.int64)])[order],
        "extra_n": np.concatenate([dc_n, ac_n, np.zeros(len(zrl_b) + len(eob_b),
                                                         np.int64)])[order],
    }


def _huffman_specs(scans: list[dict]) -> dict:
    """Huffman tables optimised (jchuff.c's way) over the symbols of
    `scans`: {("dc" or "ac", table): (16 counts, symbols)}."""
    specs = {}
    for kind, k in (("dc", 0), ("ac", 1)):
        for t in sorted({int(t) for e in scans for t in np.unique(e["tab"])}):
            freq = sum(np.bincount(e["symbol"][(e["cls"] == k) & (e["tab"] == t)], minlength=256)
                       for e in scans)
            specs[(kind, t)] = _huffman_code_lengths(freq[:256])
    return specs


def _pack_scan(e: dict, specs: dict) -> list[bytes]:
    """The scan's entropy-coded data, one bytes object per restart
    interval (padded with 1 bits, no RSTn markers)."""
    code = np.zeros(len(e["symbol"]), np.int64)
    code_n = np.zeros(len(e["symbol"]), np.int64)
    for (kind, t), spec in specs.items():
        sel = (e["cls"] == (kind == "ac")) & (e["tab"] == t)
        lookup = _huffman_codes(*spec)
        values = np.array([lookup.get(s, (0, 0)) for s in range(256)], np.int64)
        code[sel], code_n[sel] = values[e["symbol"][sel], 0], values[e["symbol"][sel], 1]
    seg = e["seg"]
    bounds = np.r_[0, np.flatnonzero(seg[1:] != seg[:-1]) + 1, len(seg)]
    return [_pack_bits(np.stack([code[a:b], e["extra"][a:b]], 1).reshape(-1),
                       np.stack([code_n[a:b], e["extra_n"][a:b]], 1).reshape(-1))
            for a, b in zip(bounds[:-1], bounds[1:])]


def huffman_scan(coefs: list[np.ndarray], sampling, members, width: int, height: int,
                 restart: int = 0) -> tuple[list[bytes], dict]:
    """The entropy-coded data of one baseline (Huffman, sequential) scan
    over the components `members` of quantised DCT coefficients `coefs`
    (as arith_jpeg takes them): one bytes object per restart interval of
    `restart` MCUs (all of it when 0), each padded with 1 bits, without
    the RSTn markers; and its Huffman tables, optimised as jchuff.c does,
    {("dc" or "ac", table): (16 counts, symbols)}. Component c codes with
    tables min(c, 1)."""
    e = _scan_entries(coefs, sampling, members, width, height, restart)
    specs = _huffman_specs([e])
    return _pack_scan(e, specs), specs


def _huffman_segments(specs: dict) -> bytes:
    return b"".join(_segment(0xC4, bytes([(kind == "ac") << 4 | t]) + bytes(counts)
                             + bytes(symbols))
                    for (kind, t), (counts, symbols) in sorted(specs.items()))


def huffman_jpeg(coefs: list[np.ndarray], quant: np.ndarray, width: int, height: int,
                 sampling=None, interleaved: bool = True, restart: int = 0,
                 markers: bytes = b"") -> tuple[bytes, list[tuple[int, int]]]:
    """A baseline JPEG (SOF0, optimised Huffman tables) of `coefs` (as
    arith_jpeg takes them): one interleaved scan, or one scan per
    component; a DRI of `restart` MCUs and RSTn markers; `markers` after
    SOI. Also the (offset, length) of each restart interval's data in the
    file, scan by scan (where a TIFF's strips point)."""
    n = len(coefs)
    sampling = sampling or [(1, 1)] * n
    out = bytearray(b"\xff\xd8" + markers)
    for t in sorted({min(c, 1) for c in range(n)}):
        out += _segment(0xDB, bytes([t]) + quant[t][JPEG_NATURAL].astype(np.uint8).tobytes())
    out += _segment(0xC0, struct.pack(">BHHB", 8, height, width, n) + b"".join(
        bytes([c + 1, sampling[c][0] << 4 | sampling[c][1], min(c, 1)]) for c in range(n)))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    places = []
    scans = [_scan_entries(coefs, sampling, members, width, height, restart)
             for members in ([tuple(range(n))] if interleaved else [(c,) for c in range(n)])]
    specs = _huffman_specs(scans)
    out += _huffman_segments(specs)  # every table before the first scan
    for members, e in zip([tuple(range(n))] if interleaved else [(c,) for c in range(n)], scans):
        segments = _pack_scan(e, specs)
        out += _segment(0xDA, bytes([len(members)]) + b"".join(
            bytes([c + 1, min(c, 1) << 4 | min(c, 1)]) for c in members) + b"\x00\x3f\x00")
        for k, data in enumerate(segments):
            if k:
                out += bytes([0xFF, 0xD0 + (k - 1) % 8])
            places.append((len(out), len(data)))
            out += data
    return bytes(out + b"\xff\xd9"), places


def _tiff_entries(entries: dict, blobs: list[bytes], endian: str = "<") -> bytes:
    """A classic TIFF of one IFD: `entries` {tag: (type, values)}, a value
    given as ("blob", k) is the offset of blobs[k], written after the IFD
    (the only value of a BYTE, ASCII or UNDEFINED tag: blobs[k] itself);
    RATIONAL values are (numerator, denominator) pairs."""
    sizes = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 7: "B", 11: "f", 12: "d"}
    head = 8 + 2 + 12 * len(entries) + 4
    at, offsets, tail = head, [], bytearray()
    for b in blobs:
        offsets.append(at + len(tail))
        tail += b + b"\0" * (len(b) % 2)
    ifd = bytearray(struct.pack(endian + "H", len(entries)))
    for tag in sorted(entries):
        typ, values = entries[tag]
        if typ in (1, 2, 7) and len(values) == 1 and isinstance(values[0], tuple):
            # A byte string held in a blob: its length and offset.
            k = values[0][1]
            ifd += struct.pack(endian + "HHII", tag, typ, len(blobs[k]), offsets[k])
            continue
        values = [offsets[v[1]] if isinstance(v, tuple) and v[0] == "blob" else v
                  for v in values]
        fmt = sizes[typ]
        raw = (bytes(values) if typ in (1, 2, 7) else
               struct.pack(endian + fmt * len(values) if typ != 5 else endian + "II" * len(values),
                           *(values if typ != 5 else [x for v in values for x in v])))
        count = len(values)
        if len(raw) <= 4:
            ifd += struct.pack(endian + "HHI", tag, typ, count) + raw.ljust(4, b"\0")
        else:
            ifd += struct.pack(endian + "HHII", tag, typ, count, head + len(tail))
            tail += raw + b"\0" * (len(raw) % 2)
    magic = b"II*\0" if endian == "<" else b"MM\0*"
    return magic + struct.pack(endian + "I", 8) + bytes(ifd) + b"\0\0\0\0" + bytes(tail)


def ojpeg_tiff(img: np.ndarray, layout: str = "tables", subsampling=(2, 2),
               rows_per_strip: int | None = None, tile: tuple[int, int] | None = None,
               planar: int = 1, quality: int = 90, sem_text: str | None = None,
               extra_tags: dict | None = None) -> bytes:
    """An old-style JPEG-in-TIFF (compression 6) of (H, W) gray or (H, W,
    3) RGB `img` (YCbCr, subsampled by `subsampling`, photometric 6),
    as libtiff's tif_ojpeg.c reads it: one JPEG frame over the image
    (strips) or over a column of tiles (`tile` = (width, length), the
    tile width at least the image's), each strip or tile one restart
    interval. layout "tables": the strips hold the entropy-coded data
    only, the tables in JPEGQTables / JPEGDCTables / JPEGACTables (one
    per component) and JPEGProc 1; "interchange": JPEGInterchangeFormat
    holds a whole JPEG stream (with DRI and RSTn markers) and the strips
    point into it. planar 2 (interchange only, 1x1): one scan per
    component. sem_text: the FEI tag 34683."""
    from cybervision_tpu_torch.imageio.jpeg_encode import quant_tables

    quant = quant_tables(quality)
    h, w = img.shape[:2]
    colour = img.ndim == 3
    hs, vs = subsampling if colour else (1, 1)
    sampling = [(hs, vs), (1, 1), (1, 1)] if colour else [(1, 1)]
    if tile:
        sw, sl = tile
        across = -(-w // sw)
        if across != 1:
            raise ValueError("ojpeg_tiff: one column of tiles")
        total = -(-h // sl) * sl
    else:
        sw, sl = w, rows_per_strip or h
        total = h
    pad = np.pad(img, ((0, total - h), (0, sw - w)) + ((0, 0),) * (img.ndim - 2), mode="edge")
    planes = ycbcr_planes(pad, sampling) if colour else [pad]
    coefs = dct_coefficients(planes, quant, sampling, sw, total)
    n_strips = -(-total // sl) if tile else -(-h // sl)
    restart = -(-sw // (8 * hs)) * (sl // (8 * vs)) if n_strips > 1 else 0
    spp = 3 if colour else 1
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * spp), 259: (3, [6]),
               262: (3, [6 if colour else 1]), 277: (3, [spp]), 284: (3, [planar])}
    if colour:
        entries[530] = (3, [hs, vs])
    if tile:
        entries[322], entries[323] = (4, [sw]), (4, [sl])
    else:
        entries[278] = (4, [sl])
    off_tag, count_tag = (324, 325) if tile else (273, 279)
    blobs: list[bytes] = []
    if sem_text is not None:
        blobs.append(sem_text.encode() + b"\0")
        entries[34683] = (2, [("blob", len(blobs) - 1)])
    if layout == "interchange":
        stream, places = huffman_jpeg(coefs, quant, sw, total, sampling, planar == 1, restart)
        blobs.append(stream)
        k = len(blobs) - 1
        entries[513], entries[514] = (4, [("blob", k)]), (4, [len(stream)])
        base = ("blob", k)
        # The strips' offsets inside the stream, fixed up once it is placed.
        entries[off_tag] = (4, [("in", k, p) for p, _ in places])
        entries[count_tag] = (4, [n for _, n in places])
    else:
        if planar != 1:
            raise ValueError("ojpeg_tiff: planar files need the interchange layout")
        segments, specs = huffman_scan(coefs, sampling, tuple(range(spp)), sw, total, restart)
        first = len(blobs)
        blobs += segments
        qt = [quant[min(c, 1)][JPEG_NATURAL].astype(np.uint8).tobytes() for c in range(spp)]
        dc = [bytes(specs[("dc", min(c, 1))][0]) + bytes(specs[("dc", min(c, 1))][1])
              for c in range(spp)]
        ac = [bytes(specs[("ac", min(c, 1))][0]) + bytes(specs[("ac", min(c, 1))][1])
              for c in range(spp)]
        tables = len(blobs)
        blobs += qt + dc + ac
        entries[512] = (3, [1])
        entries[519] = (4, [("blob", tables + c) for c in range(spp)])
        entries[520] = (4, [("blob", tables + spp + c) for c in range(spp)])
        entries[521] = (4, [("blob", tables + 2 * spp + c) for c in range(spp)])
        entries[off_tag] = (4, [("blob", first + k) for k in range(len(segments))])
        entries[count_tag] = (4, [len(s) for s in segments])
    entries.update(extra_tags or {})
    # Offsets inside a blob: its offset plus the place.
    fixed = {}
    for tag, (typ, values) in entries.items():
        if any(isinstance(v, tuple) and v[0] == "in" for v in values):
            fixed[tag] = values
            entries[tag] = (typ, [("blob", v[1]) if isinstance(v, tuple) else v for v in values])
    data = bytearray(_tiff_entries(entries, blobs))
    if fixed:
        # Rewrite the "in" values: the blob's offset (now in the IFD) plus
        # the place; the IFD holds them as LONGs.
        n = struct.unpack_from("<H", data, 8)[0]
        for e in range(n):
            tag, typ, count, value = struct.unpack_from("<HHII", data, 10 + 12 * e)
            if tag not in fixed:
                continue
            at = 10 + 12 * e + 8 if count == 1 else value
            for j, v in enumerate(fixed[tag]):
                (base_off,) = struct.unpack_from("<I", data, at + 4 * j)
                struct.pack_into("<I", data, at + 4 * j, base_off + v[2])
    return bytes(data)


def packbits(rows: np.ndarray) -> tuple[list[int], bytes]:
    """Each row of (n, W) uint8 in PackBits, as Photoshop writes PSD rows:
    runs of 3-128 equal bytes as (257 - k, value), the bytes between them
    as literals of up to 128 (n - 1, bytes). (Each row's byte count, the
    data.)"""
    n, w = rows.shape
    a = rows.reshape(-1).astype(np.int64)
    col = np.tile(np.arange(w), n)
    new = np.r_[True, a[1:] != a[:-1]] | (col == 0)
    starts = np.flatnonzero(new)
    run_id = np.cumsum(new) - 1
    length = np.diff(np.r_[starts, a.size])[run_id]
    pos = np.arange(a.size) - starts[run_id]
    chunk = np.minimum(length - (pos - pos % 128), 128)
    in_run = chunk >= 3
    run_head = in_run & (pos % 128 == 0)
    lit = ~in_run
    lit_new = lit & (np.r_[True, ~lit[:-1]] | (col == 0))
    group_start = np.maximum.accumulate(np.where(lit_new, np.arange(a.size), 0))
    lit_pos = np.arange(a.size) - group_start
    group_id = np.cumsum(lit_new) - 1
    group_len = np.bincount(group_id[lit], minlength=int(lit_new.sum()))
    lit_chunk = np.minimum(group_len[group_id] - (lit_pos - lit_pos % 128), 128)
    lit_head = lit & (lit_pos % 128 == 0)
    emit = np.where(in_run, np.where(run_head, 2, 0), np.where(lit_head, 2, 1))
    at = np.cumsum(emit) - emit
    out = np.zeros(int(emit.sum()), np.uint8)
    out[at[run_head]] = (257 - chunk[run_head]) & 0xFF
    out[at[run_head] + 1] = a[run_head]
    out[at[lit_head]] = lit_chunk[lit_head] - 1
    out[at[lit_head] + 1] = a[lit_head]
    rest = lit & ~lit_head
    out[at[rest]] = a[rest]
    counts = np.add.reduceat(emit, np.arange(0, a.size, w)).tolist()
    return counts, out.tobytes()


def psd_file(channels: np.ndarray, psd_mode: int, width: int, depth: int = 8,
             compressed: bool = False, colour_data: bytes = b"", layers: bool = False) -> bytes:
    """A Photoshop file whose composite image is `channels` (C, H, row
    bytes) uint8 as stored (bitmap mode: rows of (width + 7) // 8 bytes,
    set bits black; CMYK: each ink inverted), raw or PackBits (per-row
    counts); colour mode `psd_mode` (0 bitmap, 1 gray, 2 indexed, 3 RGB,
    4 CMYK, 7 multichannel, 8 duotone, 9 Lab), an image resource
    (the resolution info), and with `layers` a layer and mask section of
    one layer (a copy of the composite, raw)."""
    c, h, row_bytes = channels.shape
    head = b"8BPS" + struct.pack(">H6xHIIHH", 1, c, h, width, depth, psd_mode)
    resolution = struct.pack(">IHHIHH", 72 << 16, 1, 1, 72 << 16, 1, 1)
    resources = b"8BIM" + struct.pack(">H", 1005) + b"\0\0" + struct.pack(">I", len(resolution)) \
        + resolution
    layer_block = b""
    if layers:
        record = struct.pack(">iiiiH", 0, 0, h, width, c) + b"".join(
            struct.pack(">hI", k, 2 + h * row_bytes) for k in range(c))
        record += b"8BIMnorm" + bytes([255, 0, 0, 0]) + struct.pack(">I", 4 + 4 + 4) \
            + struct.pack(">II", 0, 0) + b"\x03Top"
        info = struct.pack(">h", 1) + record + b"".join(
            b"\0\0" + ch.tobytes() for ch in channels)
        info += b"\0" * (len(info) % 2)
        layer_block = struct.pack(">I", len(info)) + info + struct.pack(">I", 0)
    out = head + struct.pack(">I", len(colour_data)) + colour_data \
        + struct.pack(">I", len(resources)) + resources + struct.pack(">I", len(layer_block)) \
        + layer_block
    if compressed:
        counts, data = packbits(channels.reshape(c * h, row_bytes))
        return out + b"\0\x01" + struct.pack(f">{c * h}H", *counts) + data
    return out + b"\0\0" + channels.tobytes()


def _fits_cards(cards: list[tuple[str, str]]) -> bytes:
    text = "".join(f"{k:<8}= {v:>20}".ljust(80) for k, v in cards) + "END".ljust(80)
    return text.encode().ljust(-(-len(text) // 2880) * 2880, b" ")


def fits_file(px: np.ndarray, bitpix: int, compressed: bool = False,
              empty_primary: bool = False) -> bytes:
    """A FITS file of the (H, W) image `px` (top row first), stored as
    FITS stores an image: big-endian samples of BITPIX `bitpix` (8, 16,
    32, -32, -64), the bottom row first. `compressed`: an empty primary
    header and a tile-compressed BINTABLE (ZIMAGE, ZCMPTYPE 'GZIP_1'),
    one gzip member a row of 4-byte big-endian words; `empty_primary`: the
    image in an IMAGE extension after an empty primary header."""
    import gzip

    h, w = px.shape
    dtype = {8: ">u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}[bitpix]
    rows = np.ascontiguousarray(px[::-1])
    if not compressed:
        data = rows.astype(dtype).tobytes()
        axes = [("BITPIX", str(bitpix)), ("NAXIS", "2"), ("NAXIS1", str(w)), ("NAXIS2", str(h))]
        body = data.ljust(-(-len(data) // 2880) * 2880, b"\0")
        if not empty_primary:
            return _fits_cards([("SIMPLE", "T"), *axes]) + body
        return _fits_cards([("SIMPLE", "T"), ("BITPIX", "8"), ("NAXIS", "0"), ("EXTEND", "T")]) \
            + _fits_cards([("XTENSION", "'IMAGE   '"), *axes, ("PCOUNT", "0"),
                           ("GCOUNT", "1")]) + body
    tiles = [gzip.compress(r.astype(">i4").tobytes(), mtime=0) for r in rows]
    heap = b"".join(tiles)
    table = b"".join(struct.pack(">ii", len(t), sum(map(len, tiles[:k])))
                     for k, t in enumerate(tiles))
    body = (table + heap).ljust(-(-(len(table) + len(heap)) // 2880) * 2880, b"\0")
    return _fits_cards([("SIMPLE", "T"), ("BITPIX", "8"), ("NAXIS", "0"), ("EXTEND", "T")]) \
        + _fits_cards([("XTENSION", "'BINTABLE'"), ("BITPIX", "8"), ("NAXIS", "2"),
                       ("NAXIS1", "8"), ("NAXIS2", str(h)), ("PCOUNT", str(len(heap))),
                       ("GCOUNT", "1"), ("TFIELDS", "1"), ("TTYPE1", "'COMPRESSED_DATA'"),
                       ("TFORM1", f"'1PB({max(map(len, tiles))})'"), ("ZIMAGE", "T"),
                       ("ZBITPIX", str(bitpix)), ("ZNAXIS", "2"), ("ZNAXIS1", str(w)),
                       ("ZNAXIS2", str(h)), ("ZCMPTYPE", "'GZIP_1  '")]) + body


def pcx_file(px: np.ndarray, palette: np.ndarray | None = None) -> bytes:
    """A PCX (version 5, run-length coded) of (H, W) gray or indices (with
    a (256, 3) palette) or (H, W, 3) RGB: each byte of 0xC0 and up as a
    run of one, the others as themselves."""
    h, w = px.shape[:2]
    planes = 3 if px.ndim == 3 else 1
    stride = w + w % 2
    rows = np.zeros((h, planes, stride), np.uint8)
    rows[:, :, :w] = px.transpose(0, 2, 1) if planes == 3 else px[:, None]
    flat = rows.reshape(-1)
    high = flat >= 0xC0
    out = np.zeros(len(flat) + int(high.sum()), np.uint8)
    at = np.arange(len(flat)) + np.cumsum(high) - high
    out[at[high]] = 0xC1
    out[at + high] = flat
    head = struct.pack("<BBBBHHHHHH", 10, 5, 1, 8, 0, 0, w - 1, h - 1, 72, 72) + bytes(48) \
        + bytes([0, planes]) + struct.pack("<HH", stride, 1)
    tail = b"" if palette is None else b"\x0c" + np.ascontiguousarray(palette, np.uint8).tobytes()
    return head.ljust(128, b"\0") + out.tobytes() + tail


def dcx_file(pages: list[bytes]) -> bytes:
    """An Intel DCX of the PCX files `pages`."""
    at = 4 + 4 * (len(pages) + 1)
    offsets = []
    for p in pages:
        offsets.append(at)
        at += len(p)
    return struct.pack(f"<I{len(pages)}II", 0x3ADE68B1, *offsets, 0) + b"".join(pages)


def gbr_file(px: np.ndarray, version: int = 2, name: str = "brush") -> bytes:
    """A GIMP brush of (H, W) gray or (H, W, 4) RGBA."""
    h, w = px.shape[:2]
    depth = 4 if px.ndim == 3 else 1
    tail = name.encode() + b"\0"
    if version == 1:
        head = struct.pack(">5I", 20 + len(tail), 1, w, h, depth)
    else:
        head = struct.pack(">5I", 28 + len(tail), 2, w, h, depth) + b"GIMP" + struct.pack(">I", 25)
    return head + tail + np.ascontiguousarray(px, np.uint8).tobytes()


def imt_file(px: np.ndarray) -> bytes:
    """An IM Tools file of (H, W) gray: its key lines, a form feed, the
    rows."""
    h, w = px.shape
    return b"* IM Tools\nwidth %d\nheight %d\npixel n8\n\x0c" % (w, h) + px.tobytes()


def iptc_file(payload: bytes, size: tuple[int, int], layers: int = 1, component: int = 0,
              band: int | None = None, compression: int = 1, chunk: int = 30000) -> bytes:
    """An IPTC/NAA file: records 1 and 2, then the image's record 3
    fields (layers, size, compression, band) and `payload` in (8, 10)
    fields of at most `chunk` bytes (an extended size past 32767)."""
    def field(rec, ds, data):
        if len(data) < 0x8000:
            return bytes([0x1C, rec, ds]) + struct.pack(">H", len(data)) + data
        return bytes([0x1C, rec, ds, 0x84]) + struct.pack(">I", len(data)) + data

    out = field(1, 0, b"\0\x04") + field(2, 0, b"\0\x04") + field(2, 5, b"seeded image")
    out += field(3, 60, bytes([layers, component]))
    out += field(3, 20, struct.pack(">H", size[0])) + field(3, 30, struct.pack(">H", size[1]))
    out += field(3, 120, bytes([compression]))
    if band is not None:
        out += field(3, 65, bytes([band + 1]))
    for k in range(0, max(len(payload), 1), chunk):
        out += field(8, 10, payload[k : k + chunk])
    return out + field(9, 10, b"")


def mcidas_file(px: np.ndarray, prefix: int = 0) -> bytes:
    """A McIdas area file of (H, W) uint8, >u2 or >i4 samples, each line
    led by `prefix` bytes."""
    h, w = px.shape
    size = px.dtype.itemsize
    words = [0] * 65
    words[2], words[9], words[10], words[11], words[14] = 4, h, w, size, 1
    words[15], words[34] = prefix, 256
    head = struct.pack(">64i", *words[1:])
    rows = np.ascontiguousarray(px.astype(px.dtype.newbyteorder(">"))).view(np.uint8).reshape(h, -1)
    rows = np.concatenate([np.full((h, prefix), 0x5A, np.uint8), rows], axis=1)
    return head + rows.tobytes()


def pixar_file(rgb: np.ndarray) -> bytes:
    """A PIXAR raster of (H, W, 3) RGB."""
    h, w = rgb.shape[:2]
    head = bytearray(1024)
    head[:4] = b"\x80\xe8\x00\x00"
    struct.pack_into("<4H", head, 416, h, w, 0, 0)
    struct.pack_into("<2H", head, 424, 14, 2)
    return bytes(head) + np.ascontiguousarray(rgb, np.uint8).tobytes()


def xv_thumbnail(idx: np.ndarray) -> bytes:
    """An XV thumbnail of (H, W) 3-3-2 indices."""
    h, w = idx.shape
    return (b"P7 332\n#XVVERSION:Version 2.28  Rev: 9/26/92\n#IMGINFO:%dx%d RGB\n"
            b"#END_OF_COMMENTS\n%d %d 255\n" % (w, h, w, h)) + idx.astype(np.uint8).tobytes()


def pillow_rest_files(td: str, img1, img2) -> dict[str, list[str]]:
    """Phase 8 (o)'s inputs: phase 3's pair as colour (gray in all three
    channels) old-style JPEG-in-TIFFs, 2x2 subsampled, tables-only layout,
    64 rows a strip (ojpeg_tiff), as PackBits RGB PSDs and as BITPIX 8
    FITS files; BASELINE #3's views (tint) as CMYK PSDs (raw); and, decoded
    only, the first view as an interchange-format old-style JPEG-in-TIFF
    (2x1, 64 rows a strip), a BITPIX 16 FITS, a GZIP_1 tile-compressed
    FITS, a DCX of two pages, a GIMP brush (RGBA), an IM Tools file, an
    IPTC/NAA file holding a JPEG (huffman_jpeg), a McIdas area (16-bit
    samples behind 4-byte line prefixes), a PIXAR raster and an XV
    thumbnail. tests/gen_torch_formats_fixture.py writes the same files
    and commits the SHA-256 of Pillow's planes of them ("pillow rest")."""
    from cybervision_tpu_torch.imageio.jpeg_encode import quant_tables

    views, _, _, _ = render_perspective(PERSP_W, PERSP_H, PERSP_CAMS[:1], exact_focal=True)
    files: dict[str, list[str]] = {"ojpeg": [], "psd": [], "fits": [], "cmyk psd": [],
                                   "decode only": []}
    blobs = {}
    for k, (img, view) in enumerate(zip((img1, img2), views)):
        rgb = np.repeat(img[:, :, None], 3, axis=2)
        blobs[("ojpeg", f"rest_{k}.tif")] = ojpeg_tiff(rgb, "tables", (2, 2), rows_per_strip=64)
        blobs[("psd", f"rest_{k}.psd")] = psd_file(rgb.transpose(2, 0, 1), 3, img.shape[1],
                                                   compressed=True)
        blobs[("fits", f"rest_{k}.fits")] = fits_file(img, 8)
        # Photoshop stores each CMYK channel inverted (0: full ink).
        blobs[("cmyk psd", f"rest_view_{k}.psd")] = psd_file(
            255 - cmyk(tint(view)).transpose(2, 0, 1), 4, view.shape[1])
    rgb = tint(views[0])
    gray = (rgb.astype(np.uint32) @ np.array([19595, 38470, 7471]) + 0x8000 >> 16).astype(np.uint8)
    quant = quant_tables(JPEG_CODING_QUALITY)
    coefs = dct_coefficients([gray], quant, [(1, 1)], gray.shape[1], gray.shape[0])
    iptc_jpeg, _ = huffman_jpeg(coefs, quant, gray.shape[1], gray.shape[0])
    rgba = np.concatenate([rgb, gray[:, :, None]], axis=2)
    idx332 = (rgb[:, :, 0] & 0xE0) | (rgb[:, :, 1] >> 3 & 0x1C) | rgb[:, :, 2] >> 6
    for name, data in (
            ("rest_interchange.tif", ojpeg_tiff(rgb, "interchange", (2, 1), rows_per_strip=64)),
            ("rest_16.fits", fits_file(gray.astype(np.int64) * 200, 16)),
            ("rest_gzip.fits", fits_file(gray, 8, compressed=True)),
            ("rest.dcx", dcx_file([pcx_file(rgb), pcx_file(gray)])),
            ("rest.gbr", gbr_file(rgba)), ("rest.imt", imt_file(gray)),
            ("rest.iim", iptc_file(iptc_jpeg, gray.shape[::-1], compression=5)),
            ("rest.mcidas", mcidas_file(gray.astype(">u2") * 3, prefix=4)),
            ("rest.pxr", pixar_file(rgb)), ("rest.xv", xv_thumbnail(idx332))):
        blobs[("decode only", name)] = data
    for (kind, name), data in blobs.items():
        files[kind].append(os.path.join(td, name))
        with open(files[kind][-1], "wb") as fh:
            fh.write(data)
    return files


def cli_pillow_rest(cap, smi: str, td: str, img1, img2) -> dict:
    """Phase 8 (o), with every import of Pillow blocked (_NoPillow):
    pillow_rest_files' pairs through cli.main. The old-style JPEG-in-TIFF
    pair -> PLY, equal to reconstruct's on the decoded planes (libtiff's
    YCbCr conversion of the JPEG's samples); the PSD pair -> PNG depth map
    (--interpolation=none) and the FITS pair -> PLY, each equal to
    reconstruct's on the arrays (their planes are the arrays); the CMYK
    PSD views -> OBJ with --focal-length=43 (PSD carries no EXIF), with
    cli_exif_jpeg_pair's gates. Then the decode-only files, each timed.
    Every plane has the committed SHA-256 of Pillow's ("pillow rest")."""
    from cybervision_tpu_torch.config import (
        InterpolationMode, MeshMode, ProjectionMode, ReconstructionConfig,
    )
    from cybervision_tpu_torch.images import SourceImage
    from cybervision_tpu_torch.reconstruction import reconstruct

    with open(FORMATS_SHA256) as fh:
        committed = json.load(fh)["pillow rest"]
    t_phase = t0 = time.perf_counter()
    files = pillow_rest_files(td, img1, img2)
    written = time.perf_counter() - t0
    aff = ProjectionMode.AFFINE
    ply_cfg = ReconstructionConfig(projection=aff, mesh=MeshMode.VERTEX_COLORS)
    records = {}

    def same_as_pillow(src, path, rgb_plane=None):
        want = committed[os.path.basename(path)]
        rgb_plane = src.load_rgb_plane() if rgb_plane is None else rgb_plane
        return _plane_sha(src.img) == want["l"] and _plane_sha(rgb_plane) == want["rgb"]

    with _NoPillow():
        srcs = {kind: [SourceImage.load(p) for p in files[kind]]
                for kind in ("ojpeg", "psd", "fits", "cmyk psd")}
        hashes = {kind: all(same_as_pillow(s, p) for s, p in zip(srcs[kind], files[kind]))
                  for kind in srcs}
        exact = all(np.array_equal(s.img, im) for kind in ("psd", "fits")
                    for s, im in zip(srcs[kind], (img1, img2)))
        print(f"(o) files written in {written:.2f} s"
              f" ({[os.path.getsize(p) for ps in files.values() for p in ps]} bytes); planes equal"
              f" to Pillow's (SHA-256) {hashes}; PSD and FITS gray planes equal to the arrays"
              f" {exact}")
        if not all(hashes.values()) or not exact:
            raise AssertionError("(o): the decoded planes are not Pillow's")

        plain = [SourceImage(im) for im in (img1, img2)]
        mem = []
        for s in srcs["ojpeg"]:
            src = SourceImage(s.img)
            src.load_rgb_plane = functools.partial(np.array, s.load_rgb_plane())
            mem.append(src)
        for kind, run_name, ext, cfg, args, images in (
                ("ojpeg", "ojpeg tiff ply", "ply", ply_cfg, ["--mesh=vertex-colors"], mem),
                ("psd", "psd png", "png", ReconstructionConfig(
                    projection=aff, interpolation=InterpolationMode.NONE),
                 ["--interpolation=none"], plain),
                ("fits", "fits ply", "ply", ply_cfg, ["--mesh=vertex-colors"], plain)):
            label = f"(o) {kind} pair {SIZE}x{SIZE} -> {ext.upper()}"
            ref, out = os.path.join(td, f"mem_o_{kind}.{ext}"), os.path.join(td, f"o_{kind}.{ext}")
            reconstruct(["a", "b"], ref, cfg, quiet=True, images=images)
            run = cap.main(["--projection=parallel", *args, *files[kind], out])
            records[run_name] = cli_record(f"(o) {kind}", run["seconds"], run["rec"].phases,
                                           run["decode"], run["launches"], smi,
                                           *([run["encode"]] if ext == "png" else []))
            same = _sha(out) == _sha(ref)
            print(f"{label}: {ext.upper()} equal to the in-memory run's"
                  f" ({'the decoded planes' if kind == 'ojpeg' else 'the arrays'}) {same}")
            if not same:
                raise AssertionError(f"{label}: the {ext.upper()} differs from the in-memory"
                                     " run's")

        records["cmyk psd obj"] = cli_exif_jpeg_pair(
            cap, smi, td, "(o) CMYK PSD pair", f"(o) CMYK PSD pair {PERSP_W}x{PERSP_H} -> OBJ",
            files["cmyk psd"], srcs["cmyk psd"], {}, (PERSP_W, PERSP_H),
            focal_arg=PERSP_FOCAL_35MM)

        decode, ok = {}, {}
        for p in files["decode only"]:
            t0 = time.perf_counter()
            s = SourceImage.load(p)
            rgb_plane = s.load_rgb_plane()
            decode[os.path.basename(p)] = time.perf_counter() - t0
            ok[os.path.basename(p)] = same_as_pillow(s, p, rgb_plane)
        print(f"(o) decoded only: planes equal to Pillow's (SHA-256) {ok}; decode seconds"
              f" {json.dumps({k: round(v, 4) for k, v in decode.items()})}")
        if not all(ok.values()):
            raise AssertionError("(o): the decode-only planes are not Pillow's")
        pil = any(m == "PIL" or m.startswith("PIL.") for m in sys.modules)
    print(f"(o) Pillow imported during the runs {pil}; (o) took"
          f" {time.perf_counter() - t_phase:.1f} s")
    if pil:
        raise AssertionError("(o): Pillow was imported")
    return records



# -- phase 8 (p): block textures --------------------------------------------------------

DDPF_ALPHAPIXELS, DDPF_FOURCC, DDPF_PALETTE, DDPF_RGB, DDPF_LUMINANCE = (
    0x1, 0x4, 0x20, 0x40, 0x20000)
BC7_WEIGHTS = np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64])


def dds_file(size: tuple[int, int], payload: bytes, pfflags: int = DDPF_FOURCC,
             fourcc: bytes = b"\0\0\0\0", bitcount: int = 0, masks=(0, 0, 0, 0),
             dxgi: int | None = None) -> bytes:
    """A DDS file of (width, height) `size`: the 124-byte header (caps,
    height, width and pixel format flagged), its pixel format (`pfflags`,
    `fourcc`, `bitcount`, the four channel masks), a DX10 extension naming
    DXGI format `dxgi` where one is given, then `payload`."""
    w, h = size
    if dxgi is not None:
        fourcc = b"DX10"
    head = b"DDS " + struct.pack("<7I", 124, 0x1007, h, w, 0, 0, 0) + bytes(44)
    head += struct.pack("<2I4sI4I", 32, pfflags, fourcc, bitcount, *masks)
    head += struct.pack("<5I", 0x1000, 0, 0, 0, 0)
    if dxgi is not None:
        head += struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return head + payload


def texture_blocks(px: np.ndarray) -> np.ndarray:
    """(n, 16, c) int64: the 4x4 blocks of (H, W, c) pixels, a row of
    blocks after another, the edge pixels repeated out to a multiple of 4."""
    h, w, c = px.shape
    hp, wp = -(-h // 4) * 4, -(-w // 4) * 4
    px = np.pad(px, ((0, hp - h), (0, wp - w), (0, 0)), mode="edge").astype(np.int64)
    return px.reshape(hp // 4, 4, wp // 4, 4, c).transpose(0, 2, 1, 3, 4).reshape(-1, 16, c)


def _nearest(blocks: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """(n, 16): each pixel's nearest entry of its block's (n, k, c) palette."""
    d = ((blocks[:, :, None, :] - palette[:, None, :, :]) ** 2).sum(axis=3)
    return d.argmin(axis=2)


def _packed(idx: np.ndarray, bits: int) -> np.ndarray:
    """(n,) uint64 of (n, 16) indices of `bits` bits, pixel 0 lowest."""
    shifts = np.arange(16, dtype=np.uint64) * np.uint64(bits)
    return np.bitwise_or.reduce(idx.astype(np.uint64) << shifts, axis=1)


def bc1_colour_blocks(rgb: np.ndarray) -> np.ndarray:
    """(n, 8) uint8 BC1 colour blocks of (H, W, 3) pixels: each block's
    channel maxima and minima as the 5:6:5 endpoints c0 >= c1 (the
    four-colour mode, one colour where they meet), each pixel the nearest
    of the four colours."""
    b = texture_blocks(rgb)

    def q565(v):
        return ((v[:, 0] * 31 + 127) // 255) << 11 | ((v[:, 1] * 63 + 127) // 255) << 5 \
            | (v[:, 2] * 31 + 127) // 255

    def rgb888(c):
        return np.stack([(c >> 11) * 255 // 31, (c >> 5 & 63) * 255 // 63, (c & 31) * 255 // 31],
                        axis=1)

    c0, c1 = q565(b.max(axis=1)), q565(b.min(axis=1))
    e0, e1 = rgb888(c0), rgb888(c1)
    idx = _nearest(b, np.stack([e0, e1, (2 * e0 + e1) // 3, (e0 + 2 * e1) // 3], axis=1))
    idx[c0 == c1] = 0
    out = np.zeros((len(b), 8), np.uint8)
    out[:, 0:2] = c0.astype("<u2").view(np.uint8).reshape(-1, 2)
    out[:, 2:4] = c1.astype("<u2").view(np.uint8).reshape(-1, 2)
    out[:, 4:8] = _packed(idx, 2).astype("<u4").view(np.uint8).reshape(-1, 4)
    return out


def bc3_alpha_blocks(plane: np.ndarray) -> np.ndarray:
    """(n, 8) uint8 BC3 alpha (and BC4) blocks of an (H, W) plane: the
    block's maximum and minimum as a0 > a1 (eight levels), each pixel the
    nearest level; where they meet, one level."""
    b = texture_blocks(plane[:, :, None])
    a0, a1 = b.max(axis=1), b.min(axis=1)
    k = np.arange(2, 8)
    levels = np.concatenate([a0, a1, ((8 - k) * a0 + (k - 1) * a1) // 7], axis=1)
    idx = _nearest(b, levels[:, :, None])
    idx[a0[:, 0] == a1[:, 0]] = 0
    out = np.zeros((len(b), 8), np.uint8)
    out[:, 0], out[:, 1] = a0[:, 0], a1[:, 0]
    out[:, 2:8] = _packed(idx, 3).astype("<u8").view(np.uint8).reshape(-1, 8)[:, :6]
    return out


def bc1_file(rgb: np.ndarray) -> bytes:
    """A DXT1 DDS of (H, W, 3) pixels."""
    return dds_file(rgb.shape[1::-1], bc1_colour_blocks(rgb).tobytes(), fourcc=b"DXT1")


def dxt5_blocks(rgba: np.ndarray) -> bytes:
    """BC3 (DXT5) blocks of (H, W, 4) pixels: the alpha block, then the
    colour block."""
    return np.concatenate([bc3_alpha_blocks(rgba[:, :, 3]), bc1_colour_blocks(rgba[:, :, :3])],
                          axis=1).tobytes()


def bc7_mode6_blocks(rgba: np.ndarray) -> bytes:
    """BC7 blocks of (H, W, 4) pixels, all of mode 6 (one subset, RGBA
    endpoints of 7 bits and a p-bit each, 4-bit indices): each block's
    channel minima (p-bit 0) and maxima (p-bit 1) as its endpoints, each
    pixel's index the weight nearest its projection onto the segment
    between them, the endpoints swapped where pixel 0's index would need
    its top bit (its anchor index has 3)."""
    b = texture_blocks(rgba)
    e0 = b.min(axis=1) >> 1 << 1
    e1 = b.max(axis=1) | 1
    span = e1 - e0
    t = ((b - e0[:, None, :]) * span[:, None, :]).sum(axis=2) * 64
    norm = np.maximum((span * span).sum(axis=1), 1)[:, None]
    mids = (BC7_WEIGHTS[1:] + BC7_WEIGHTS[:-1]) / 2
    idx = np.searchsorted(mids, t / norm).astype(np.int64)
    flip = idx[:, 0] >= 8
    idx[flip] = 15 - idx[flip]
    e0[flip], e1[flip] = e1[flip].copy(), e0[flip].copy()
    lo = np.full(len(b), 0x40, np.uint64)
    for c in range(4):
        lo |= (e0[:, c] >> 1).astype(np.uint64) << np.uint64(7 + 14 * c)
        lo |= (e1[:, c] >> 1).astype(np.uint64) << np.uint64(14 + 14 * c)
    lo |= (e0[:, 0] & 1).astype(np.uint64) << np.uint64(63)
    hi = (e1[:, 0] & 1).astype(np.uint64) | idx[:, 0].astype(np.uint64) << np.uint64(1)
    hi |= _packed(idx, 4) & ~np.uint64(15)
    return np.stack([lo, hi], axis=1).astype("<u8").tobytes()


def dds_masked(rgb: np.ndarray, bitcount: int, masks: tuple, alpha=None) -> bytes:
    """An uncompressed DDS of (H, W, 3) pixels (and an (H, W) alpha plane)
    in `bitcount` bits a pixel, each channel scaled down to its mask."""
    chans = [rgb[:, :, 0], rgb[:, :, 1], rgb[:, :, 2]] + ([alpha] if alpha is not None else [])
    value = np.zeros(rgb.shape[:2], np.uint64)
    for ch, mask in zip(chans, masks):
        if not mask:
            continue
        shift = (mask & -mask).bit_length() - 1
        value |= (ch.astype(np.uint64) * np.uint64(mask >> shift) // np.uint64(255)) \
            << np.uint64(shift)
    data = value.astype("<u8").view(np.uint8).reshape(-1, 8)[:, : bitcount // 8].tobytes()
    flags = DDPF_RGB | (DDPF_ALPHAPIXELS if alpha is not None else 0)
    return dds_file(rgb.shape[1::-1], data, flags, bitcount=bitcount,
                    masks=tuple(masks) + (0,) * (4 - len(masks)))


def blp1_file(size: tuple[int, int], body: bytes, alpha: bool = False,
              jpeg_header: bytes | None = None, encoding: int = 5) -> bytes:
    """A BLP1 file: of compression 0 with `jpeg_header` (its JPEG split
    into the shared header and the first mipmap's data, `body`), else of
    compression 1 and `encoding`, `body` the 1,024-byte BGRA palette and
    the indices."""
    w, h = size
    head = b"BLP1" + struct.pack("<iIIIiI", 0 if jpeg_header is not None else 1, 8 * alpha, w, h,
                                 encoding, 0)
    if jpeg_header is None:
        offset, length, extra = 28 + 128 + 1024, len(body) - 1024, b""
    else:
        extra = struct.pack("<I", len(jpeg_header)) + jpeg_header
        offset, length = 28 + 128 + len(extra), len(body)
    return head + struct.pack("<16I", offset, *[0] * 15) + struct.pack(
        "<16I", length, *[0] * 15) + extra + body


def blp2_file(size: tuple[int, int], payload: bytes, encoding: int, alpha: bool = True,
              alpha_encoding: int = 7, palette: bytes = bytes(1024)) -> bytes:
    """A BLP2 file of compression 1: `encoding` 1 (indices into `palette`,
    1,024 bytes of BGRA) or 2 (DXT blocks of `alpha_encoding` 0, 1 or 7)."""
    w, h = size
    head = b"BLP2" + struct.pack("<ibbbbII", 1, encoding, 8 * alpha, alpha_encoding, 0, w, h)
    offset = 20 + 128 + len(palette)
    return head + struct.pack("<16I", offset, *[0] * 15) + struct.pack(
        "<16I", len(payload), *[0] * 15) + palette + payload


def ftex_file(size: tuple[int, int], mipmap: bytes, fmt: int) -> bytes:
    """An FTEX file of one format (0 DXT1, 1 raw RGB) and one mipmap,
    which follows the 32-byte header."""
    return b"FTEX" + struct.pack("<7i", 1, *size, 1, 1, fmt, 32) \
        + struct.pack("<i", len(mipmap)) + mipmap


def rgb_jpeg(rgb: np.ndarray, quality: int = JPEG_CODING_QUALITY) -> bytes:
    """A baseline YCbCr JPEG of (H, W, 3) pixels, no subsampling
    (huffman_jpeg)."""
    from cybervision_tpu_torch.imageio.jpeg_encode import quant_tables

    quant = quant_tables(quality)
    h, w = rgb.shape[:2]
    planes = ycbcr_planes(rgb, [(1, 1)] * 3)
    return huffman_jpeg(dct_coefficients(planes, quant, [(1, 1)] * 3, w, h), quant, w, h)[0]



BLOCK_TEXTURE_LARGE = "tex_large_bc7.dds"  # phase 8 (p)'s 4032x3024 BC7 plane


def block_texture_files(td: str, img1, img2, large: bool = True) -> dict[str, list[str]]:
    """Phase 8 (p)'s inputs: phase 3's pair as DXT1 DDS files (bc1_file)
    and as BC7 DDS files (DX10, mode 6: bc7_mode6_blocks); BASELINE #3's
    views (tint) as BLP2 DXT5 (dxt5_blocks); and, decoded only, with
    `large` a 4032x3024 BC7 plane (the first image's blocks tiled), seeded
    random BC6H blocks (unsigned and signed) and BC5S blocks, the first
    view as BC4 (its gray plane), as a 5:6:5 DDS, an LA DDS and a palette
    DDS (quantised), as BLP1 JPEG and palette files and as FTEX DXT1 and
    raw files. tests/gen_torch_formats_fixture.py writes the same files
    and commits the SHA-256 of Pillow's planes of them ("block textures")."""
    views, _, _, _ = render_perspective(PERSP_W, PERSP_H, PERSP_CAMS[:1], exact_focal=True)
    files: dict[str, list[str]] = {"bc1 dds": [], "bc7 dds": [], "blp dxt5": [],
                                   "decode only": []}
    blobs = {}
    opaque = np.full(img1.shape + (1,), 255, np.uint8)
    bc7 = []
    for k, (img, view) in enumerate(zip((img1, img2), views)):
        rgb = np.repeat(img[:, :, None], 3, axis=2)
        blobs[("bc1 dds", f"tex_{k}.dds")] = bc1_file(rgb)
        bc7.append(bc7_mode6_blocks(np.concatenate([rgb, opaque], axis=2)))
        blobs[("bc7 dds", f"tex_bc7_{k}.dds")] = dds_file(img.shape[::-1], bc7[-1], dxgi=98)
        t = tint(view)
        blobs[("blp dxt5", f"tex_view_{k}.blp")] = blp2_file(
            t.shape[1::-1], dxt5_blocks(np.concatenate([t, np.full(t.shape[:2] + (1,), 255,
                                                                   np.uint8)], axis=2)), 2)
    if large:
        # The first image's blocks tiled: its side is a multiple of 4, so
        # these are the blocks of the tiled image.
        grid = np.frombuffer(bc7[0], np.uint8).reshape(img1.shape[0] // 4, img1.shape[1] // 4, 16)
        reps = (-(-LARGE_H // img1.shape[0]), -(-LARGE_W // img1.shape[1]), 1)
        tiled = np.tile(grid, reps)[: LARGE_H // 4, : LARGE_W // 4]
        blobs[("decode only", BLOCK_TEXTURE_LARGE)] = dds_file((LARGE_W, LARGE_H),
                                                               tiled.tobytes(), dxgi=98)
    rgb = tint(views[0])
    size = rgb.shape[1::-1]
    gray = (rgb.astype(np.uint32) @ np.array([19595, 38470, 7471]) + 0x8000 >> 16).astype(np.uint8)
    rng = np.random.RandomState(20)
    idx, colours = quantised(rgb, 6)
    rgba_pal = np.zeros((256, 4), np.uint8)
    rgba_pal[: len(colours), :3], rgba_pal[:, 3] = colours, 255
    jpeg = rgb_jpeg(rgb)
    sos = jpeg.index(b"\xff\xda")
    for name, data in (
            ("tex_bc6h_unsigned.dds", dds_file((256, 256), rng.bytes(64 * 64 * 16), dxgi=95)),
            ("tex_bc6h_signed.dds", dds_file((256, 256), rng.bytes(64 * 64 * 16), dxgi=96)),
            ("tex_bc4.dds", dds_file(size, bc3_alpha_blocks(gray).tobytes(), fourcc=b"ATI1")),
            ("tex_bc5s.dds", dds_file((256, 256), rng.bytes(64 * 64 * 16), fourcc=b"BC5S")),
            ("tex_565.dds", dds_masked(rgb, 16, (0xF800, 0x07E0, 0x001F))),
            ("tex_la.dds", dds_file(size, np.stack([gray, rgb[:, :, 0]], axis=2).tobytes(),
                                    DDPF_LUMINANCE | DDPF_ALPHAPIXELS, bitcount=16)),
            ("tex_palette.dds", dds_file(size, rgba_pal.tobytes() + idx.astype(np.uint8).tobytes(),
                                         DDPF_PALETTE)),
            ("tex_jpeg.blp", blp1_file(size, jpeg[sos:], jpeg_header=jpeg[:sos])),
            ("tex_palette.blp", blp1_file(size, rgba_pal[:, [2, 1, 0, 3]].tobytes()
                                          + idx.astype(np.uint8).tobytes())),
            ("tex_dxt1.ftc", ftex_file(size, bc1_colour_blocks(rgb).tobytes(), 0)),
            ("tex_rgb.ftu", ftex_file(size, rgb.tobytes(), 1))):
        blobs[("decode only", name)] = data
    for (kind, name), data in blobs.items():
        files[kind].append(os.path.join(td, name))
        with open(files[kind][-1], "wb") as fh:
            fh.write(data)
    return files


def cli_block_textures(cap, smi: str, td: str, img1, img2) -> dict:
    """Phase 8 (p), with every import of Pillow blocked (_NoPillow):
    block_texture_files' pairs through cli.main. The DXT1 DDS pair -> PLY
    and the BC7 DDS pair -> PNG depth map (--interpolation=none), each
    equal to reconstruct's on the decoded planes; the BLP2 DXT5 views ->
    OBJ with --focal-length=43 (BLP carries no EXIF), with
    cli_exif_jpeg_pair's gates. Then the decode-only files, each timed.
    Every plane has the committed SHA-256 of Pillow's ("block textures")."""
    from cybervision_tpu_torch.config import (
        InterpolationMode, MeshMode, ProjectionMode, ReconstructionConfig,
    )
    from cybervision_tpu_torch.images import SourceImage
    from cybervision_tpu_torch.reconstruction import reconstruct

    with open(FORMATS_SHA256) as fh:
        committed = json.load(fh)["block textures"]
    t_phase = t0 = time.perf_counter()
    files = block_texture_files(td, img1, img2)
    written = time.perf_counter() - t0
    aff = ProjectionMode.AFFINE
    records = {}

    def same_as_pillow(src, path, rgb_plane=None):
        want = committed[os.path.basename(path)]
        rgb_plane = src.load_rgb_plane() if rgb_plane is None else rgb_plane
        return _plane_sha(src.img) == want["l"] and _plane_sha(rgb_plane) == want["rgb"]

    with _NoPillow():
        srcs = {kind: [SourceImage.load(p) for p in files[kind]]
                for kind in ("bc1 dds", "bc7 dds", "blp dxt5")}
        hashes = {kind: all(same_as_pillow(s, p) for s, p in zip(srcs[kind], files[kind]))
                  for kind in srcs}
        print(f"(p) files written in {written:.2f} s"
              f" ({[os.path.getsize(p) for ps in files.values() for p in ps]} bytes); planes equal"
              f" to Pillow's (SHA-256) {hashes}")
        if not all(hashes.values()):
            raise AssertionError("(p): the decoded planes are not Pillow's")

        for kind, run_name, ext, cfg, args in (
                ("bc1 dds", "bc1 dds ply", "ply",
                 ReconstructionConfig(projection=aff, mesh=MeshMode.VERTEX_COLORS),
                 ["--mesh=vertex-colors"]),
                ("bc7 dds", "bc7 dds png", "png", ReconstructionConfig(
                    projection=aff, interpolation=InterpolationMode.NONE),
                 ["--interpolation=none"])):
            label = f"(p) {kind} pair {SIZE}x{SIZE} -> {ext.upper()}"
            mem = []
            for s in srcs[kind]:
                src = SourceImage(s.img)
                src.load_rgb_plane = functools.partial(np.array, s.load_rgb_plane())
                mem.append(src)
            ref, out = os.path.join(td, f"mem_p_{ext}.{ext}"), os.path.join(td, f"p_{ext}.{ext}")
            reconstruct(["a", "b"], ref, cfg, quiet=True, images=mem)
            run = cap.main(["--projection=parallel", *args, *files[kind], out])
            records[run_name] = cli_record(f"(p) {kind}", run["seconds"], run["rec"].phases,
                                           run["decode"], run["launches"], smi,
                                           *([run["encode"]] if ext == "png" else []))
            same = _sha(out) == _sha(ref)
            print(f"{label}: {ext.upper()} equal to the in-memory run's (the decoded planes)"
                  f" {same}")
            if not same:
                raise AssertionError(f"{label}: the {ext.upper()} differs from the in-memory"
                                     " run's")

        records["blp dxt5 obj"] = cli_exif_jpeg_pair(
            cap, smi, td, "(p) BLP2 DXT5 pair", f"(p) BLP2 DXT5 pair {PERSP_W}x{PERSP_H} -> OBJ",
            files["blp dxt5"], srcs["blp dxt5"], {}, (PERSP_W, PERSP_H),
            focal_arg=PERSP_FOCAL_35MM)

        decode, ok = {}, {}
        for p in files["decode only"]:
            t0 = time.perf_counter()
            s = SourceImage.load(p)
            rgb_plane = s.load_rgb_plane()
            decode[os.path.basename(p)] = time.perf_counter() - t0
            ok[os.path.basename(p)] = same_as_pillow(s, p, rgb_plane)
        print(f"(p) decoded only: planes equal to Pillow's (SHA-256) {ok}; decode seconds"
              f" {json.dumps({k: round(v, 4) for k, v in decode.items()})}")
        if not all(ok.values()):
            raise AssertionError("(p): the decode-only planes are not Pillow's")
        pil = any(m == "PIL" or m.startswith("PIL.") for m in sys.modules)
    print(f"(p) Pillow imported during the runs {pil}; (p) took"
          f" {time.perf_counter() - t_phase:.1f} s")
    if pil:
        raise AssertionError("(p): Pillow was imported")
    return records



# -- phase 8 (q): FLI/FLC, Photo CD and the raw depth-map writers ----------------------

FLI_BRUN, FLI_LC, FLI_SS2, FLI_BLACK, FLI_COPY = 15, 12, 7, 13, 16
FLI_COLOR_256, FLI_COLOR_64, FLI_PSTAMP = 4, 11, 18


def fli_chunk(kind: int, body: bytes) -> bytes:
    """A frame's sub-chunk: its size (header included), type and body."""
    return struct.pack("<IH", 6 + len(body), kind) + body


def fli_file(size: tuple[int, int], frames: list[list[bytes]], magic: int = 0xAF12,
             prefix: bytes | None = None) -> bytes:
    """An FLI (magic 0xAF11) or FLC (0xAF12) file of (width, height)
    `size`: the 128-byte header (8 bits a pixel, zeros where Pillow checks
    for them), an optional 0xF100 prefix chunk of body `prefix`, then one
    frame chunk (0xF1FA) of each list of sub-chunks."""
    w, h = size
    head = struct.pack("<IHHHHHHI", 0, magic, len(frames), w, h, 8, 0, 5).ljust(128, b"\0")
    body = b"" if prefix is None else struct.pack("<IH", 6 + len(prefix), 0xF100) + prefix
    for chunks in frames:
        data = b"".join(chunks)
        body += struct.pack("<IHH", 16 + len(data), 0xF1FA, len(chunks)) + bytes(8) + data
    return struct.pack("<I", len(head) + len(body)) + head[4:] + body


def fli_color(palette: np.ndarray, kind: int = FLI_COLOR_256, packets=None) -> bytes:
    """A COLOR chunk (type 4, or 11 with 6-bit values) of `packets`, each
    (skip, first entry, count: 0 for 256) over the (256, 3) palette
    (values as stored); the default one packet of all 256 entries."""
    packets = packets or [(0, 0, 0)]
    body = struct.pack("<H", len(packets))
    for skip, first, count in packets:
        body += bytes([skip, count]) + palette[first : first + (count or 256)].astype(
            np.uint8).tobytes()
    return fli_chunk(kind, body)


def fli_brun(px: np.ndarray) -> bytes:
    """A BRUN chunk of (H, W) uint8: each line its packet count, then runs
    (a count up to 127 and a byte) of 3 or more equal bytes and literals
    (256 - n, then n bytes, n up to 128)."""
    body = bytearray()
    for row in px:
        packets, x, w = bytearray(), 0, len(row)
        n_packets = 0
        while x < w:
            run = 1
            while x + run < w and run < 127 and row[x + run] == row[x]:
                run += 1
            if run >= 3:
                packets += bytes([run, row[x]])
                x += run
            else:
                end = x
                while end < w and end - x < 128 and not (
                        end + 2 < w and row[end] == row[end + 1] == row[end + 2]):
                    end += 1
                packets += bytes([256 - (end - x)]) + row[x:end].tobytes()
                x = end
            n_packets += 1
        body += bytes([n_packets & 255]) + packets
    return fli_chunk(FLI_BRUN, bytes(body))


def fli_lc(first: int, lines: list[list[tuple[int, int, bytes]]]) -> bytes:
    """An LC chunk from line `first`: each line's packets (skip, n, data):
    n > 0 copies the n bytes of data, n < 0 repeats its one byte -n times."""
    body = bytearray(struct.pack("<HH", first, len(lines)))
    for packets in lines:
        body.append(len(packets))
        for skip, n, data in packets:
            body += bytes([skip, n & 255]) + data
    return fli_chunk(FLI_LC, bytes(body))


def fli_ss2(lines: list[tuple[int, int | None, list[tuple[int, int, bytes]]]]) -> bytes:
    """An SS2 chunk: each line (lines skipped before it, its last byte or
    None, its packets (skip, n, data): n > 0 copies n words, n < 0 repeats
    one word -n times)."""
    body = bytearray(struct.pack("<H", len(lines)))
    for skip, last, packets in lines:
        if skip:
            body += struct.pack("<H", 65536 - skip)
        if last is not None:
            body += struct.pack("<H", 0x8000 | last)
        body += struct.pack("<H", len(packets))
        for s, n, data in packets:
            body += bytes([s, n & 255]) + data
    return fli_chunk(FLI_SS2, bytes(body))


def fli_delta_lc(old: np.ndarray, new: np.ndarray) -> bytes:
    """An LC chunk that turns `old` into `new`: the lines that differ,
    each a packet of a skip and a literal of its changed span (whole
    lines past 255 columns in pieces of up to 127 bytes)."""
    changed = np.flatnonzero((old != new).any(axis=1))
    if not len(changed):
        return fli_lc(0, [])
    first, last = int(changed[0]), int(changed[-1])
    lines = []
    for y in range(first, last + 1):
        packets, x = [], 0
        cols = np.flatnonzero(old[y] != new[y])
        if len(cols):
            x0, x1 = int(cols[0]), int(cols[-1]) + 1
            skip = x0
            while skip > 255:
                packets.append((255, 0, b""))
                skip -= 255
            x = x0
            while x < x1:
                n = min(127, x1 - x)
                packets.append((skip, n, new[y, x : x + n].tobytes()))
                skip, x = 0, x + n
        lines.append(packets)
    return fli_lc(first, lines)


def pcd_file(rgb: np.ndarray, orientation: int = 0) -> bytes:
    """A Photo CD file of (512, 768, 3) RGB: "PCD_" at byte 2048, the
    orientation in its byte 1538, the base image from byte 96 x 2048 as
    Pillow's "pcd" decoder reads it (two luma rows, then 384 samples of
    each chroma, the mean of two columns of both rows), each sample of
    PhotoYCC from RGB (Y = 0.5882 luma, C1 and C2 the scaled blue and red
    differences around 156 and 137), rounded and clipped."""
    f = rgb.astype(np.float64)
    luma = 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
    planes = [luma / 1.3584, (f[..., 2] - luma) / 2.2179 + 156, (f[..., 0] - luma) / 1.8215 + 137]
    y, c1, c2 = (np.clip(np.floor(p + 0.5), 0, 255).astype(np.uint8) for p in planes)
    h, w = y.shape

    def half(c):
        return np.floor(c.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3)) + 0.5).astype(np.uint8)

    body = np.concatenate([y.reshape(h // 2, 2 * w), half(c1), half(c2)], axis=1)
    head = bytearray(96 * 2048)
    head[2048:2052] = b"PCD_"
    head[2048 + 1538] = orientation
    return bytes(head) + body.tobytes()



def fli_delta_ss2(old: np.ndarray, new: np.ndarray) -> bytes:
    """An SS2 chunk that turns `old` into `new` ((H, W) uint8): the lines
    that differ, after a skip of the equal lines before them, each with
    its last byte where the width is odd, then packets over its words:
    runs of 3 or more equal words (n < 0) and literals of up to 127."""
    h, w = new.shape
    lines, skip = [], 0
    for y in range(h):
        if np.array_equal(old[y], new[y]):
            skip += 1
            continue
        words = new[y, : w - w % 2].reshape(-1, 2)
        packets, x = [], 0
        while x < len(words):
            run = 1
            while x + run < len(words) and run < 128 and (words[x + run] == words[x]).all():
                run += 1
            if run >= 3:
                packets.append((0, -run, words[x].tobytes()))
                x += run
            else:
                n = min(127, len(words) - x)
                packets.append((0, n, words[x : x + n].tobytes()))
                x += n
        lines.append((skip, int(new[y, -1]) if w % 2 else None, packets))
        skip = 0
    return fli_ss2(lines)


def fli_pcd_files(td: str, img1, img2) -> dict[str, list[str]]:
    """Phase 8 (q)'s inputs: phase 3's pair as FLC files (a COLOR_256
    gray ramp and a BRUN chunk), and cropped to 768x512 as Photo CD files
    (pcd_file), unrotated and at orientation 1; decoded only, BASELINE
    #3's first view (tint, quantised) as an FLI with a COLOR_64 palette
    and a BRUN chunk, and as FLCs whose first frame is BLACK then LC, SS2
    at an odd width (319 columns, blank lines skipped) or COPY.
    tests/gen_torch_formats_fixture.py writes the same files and commits
    the SHA-256 of Pillow's planes of them ("fli pcd")."""
    views, _, _, _ = render_perspective(PERSP_W, PERSP_H, PERSP_CAMS[:1], exact_focal=True)
    gray = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    blobs = {}
    for k, img in enumerate((img1, img2)):
        blobs[("flc pair", f"sem_{k}.flc")] = fli_file(
            img.shape[::-1], [[fli_color(gray), fli_brun(img)]])
        # The 768x512 crop (a smaller image repeated to it, for rehearsals).
        crop = np.pad(img, ((0, max(0, 512 - img.shape[0])), (0, max(0, 768 - img.shape[1]))),
                      mode="wrap")[:512, :768]
        rgb = np.repeat(crop[:, :, None], 3, axis=2)
        blobs[("pcd pair", f"sem_{k}.pcd")] = pcd_file(rgb)
        blobs[("pcd rotated pair", f"sem_rot_{k}.pcd")] = pcd_file(rgb, 1)
    idx, colours = quantised(tint(views[0]), 6)
    idx = idx.astype(np.uint8)
    pal = np.zeros((256, 3), np.uint8)
    pal[: len(colours)] = colours
    odd = idx[:, :319].copy()
    odd[10:20] = 0
    size = idx.shape[::-1]
    zeros = np.zeros_like(idx)
    for name, data in (
            ("view_color64.fli", fli_file(size, [[fli_color(pal >> 2, FLI_COLOR_64),
                                                  fli_brun(idx)]], magic=0xAF11)),
            ("view_black_lc.flc", fli_file(size, [[fli_color(pal), fli_chunk(FLI_BLACK, b""),
                                                   fli_delta_lc(zeros, idx)]])),
            ("view_ss2_odd.flc", fli_file(odd.shape[::-1], [[fli_color(pal), fli_delta_ss2(
                np.zeros_like(odd), odd)]])),
            ("view_copy.flc", fli_file(size, [[fli_color(pal), fli_chunk(FLI_COPY,
                                                                         idx.tobytes())]]))):
        blobs[("decode only", name)] = data
    files: dict[str, list[str]] = {}
    for (kind, name), data in blobs.items():
        files.setdefault(kind, []).append(os.path.join(td, name))
        with open(files[kind][-1], "wb") as fh:
            fh.write(data)
    return files


RAW_DEPTH_EXTS = (".tga", ".sgi", ".im", ".dib", ".dds")  # phase 8 (q)'s _save_image files


def cli_fli_pcd_writers(cap, smi: str, td: str, img1, img2, tifs: list[str]) -> dict:
    """Phase 8 (q), with every import of Pillow blocked (_NoPillow):
    fli_pcd_files' pairs through cli.main. The FLC pair -> PLY, the
    Photo CD pairs (unrotated and at orientation 1) -> PNG depth maps
    (--interpolation=none), each byte-equal to reconstruct's on the
    decoded planes; the decode-only FLIs, each timed. Every plane has the
    committed SHA-256 of Pillow's ("fli pcd"). Then (a)'s SEM TIFF pair ->
    .qoi and .ppm depth maps: the QOI decodes (the port's reader) to an
    RGBA whose encode_qoi and encode_ppm are the files' bytes; writers.
    _save_image writes that RGBA as .tga, .sgi, .im, .dib and .dds, each
    encode-and-write timed, each file rgba_encode's bytes and read back by
    the port's readers to the RGBA (RGB for the DIB)."""
    from cybervision_tpu_torch.config import (
        InterpolationMode, MeshMode, ProjectionMode, ReconstructionConfig,
    )
    from cybervision_tpu_torch.imageio import open_image, rgba_encode
    from cybervision_tpu_torch.images import SourceImage
    from cybervision_tpu_torch.output import writers
    from cybervision_tpu_torch.reconstruction import reconstruct

    with open(FORMATS_SHA256) as fh:
        committed = json.load(fh)["fli pcd"]
    t_phase = t0 = time.perf_counter()
    files = fli_pcd_files(td, img1, img2)
    written = time.perf_counter() - t0
    aff = ProjectionMode.AFFINE
    records = {}

    def same_as_pillow(src, path, rgb_plane=None):
        want = committed[os.path.basename(path)]
        rgb_plane = src.load_rgb_plane() if rgb_plane is None else rgb_plane
        return _plane_sha(src.img) == want["l"] and _plane_sha(rgb_plane) == want["rgb"]

    with _NoPillow():
        srcs = {kind: [SourceImage.load(p) for p in files[kind]]
                for kind in ("flc pair", "pcd pair", "pcd rotated pair")}
        hashes = {kind: all(same_as_pillow(s, p) for s, p in zip(srcs[kind], files[kind]))
                  for kind in srcs}
        print(f"(q) files written in {written:.2f} s"
              f" ({[os.path.getsize(p) for ps in files.values() for p in ps]} bytes); planes equal"
              f" to Pillow's (SHA-256) {hashes}")
        if not all(hashes.values()):
            raise AssertionError("(q): the decoded planes are not Pillow's")

        for kind, run_name, ext, cfg, args in (
                ("flc pair", "flc ply", "ply",
                 ReconstructionConfig(projection=aff, mesh=MeshMode.VERTEX_COLORS),
                 ["--mesh=vertex-colors"]),
                ("pcd pair", "pcd png", "png", ReconstructionConfig(
                    projection=aff, interpolation=InterpolationMode.NONE),
                 ["--interpolation=none"]),
                ("pcd rotated pair", "pcd rotated png", "png", ReconstructionConfig(
                    projection=aff, interpolation=InterpolationMode.NONE),
                 ["--interpolation=none"])):
            h, w = srcs[kind][0].img.shape
            label = f"(q) {kind} {w}x{h} -> {ext.upper()}"
            mem = []
            for s in srcs[kind]:
                src = SourceImage(s.img)
                src.load_rgb_plane = functools.partial(np.array, s.load_rgb_plane())
                mem.append(src)
            tag = run_name.replace(" ", "_")
            ref, out = os.path.join(td, f"mem_q_{tag}.{ext}"), os.path.join(td, f"q_{tag}.{ext}")
            reconstruct(["a", "b"], ref, cfg, quiet=True, images=mem)
            run = cap.main(["--projection=parallel", *args, *files[kind], out])
            records[run_name] = cli_record(f"(q) {kind}", run["seconds"], run["rec"].phases,
                                           run["decode"], run["launches"], smi,
                                           *([run["encode"]] if ext == "png" else []))
            same = _sha(out) == _sha(ref)
            print(f"{label}: {ext.upper()} equal to the in-memory run's (the decoded planes)"
                  f" {same}")
            if not same:
                raise AssertionError(f"{label}: the {ext.upper()} differs from the in-memory"
                                     " run's")

        decode, ok = {}, {}
        for p in files["decode only"]:
            t0 = time.perf_counter()
            s = SourceImage.load(p)
            rgb_plane = s.load_rgb_plane()
            decode[os.path.basename(p)] = time.perf_counter() - t0
            ok[os.path.basename(p)] = same_as_pillow(s, p, rgb_plane)
        print(f"(q) decoded only: planes equal to Pillow's (SHA-256) {ok}; decode seconds"
              f" {json.dumps({k: round(v, 4) for k, v in decode.items()})}")
        if not all(ok.values()):
            raise AssertionError("(q): the decode-only planes are not Pillow's")

        label = f"(q) SEM TIFF pair {SIZE}x{SIZE}+{SEM_DATABAR} -> raw depth maps"
        argv = ["--projection=parallel", "--interpolation=none", *tifs]
        runs = {}
        for ext in (".qoi", ".ppm"):
            runs[ext] = cap.main([*argv, os.path.join(td, f"depth_q{ext}")])
        mode, rgba, _ = open_image(os.path.join(td, "depth_q.qoi")).decode()
        checks = {".qoi": _sha(os.path.join(td, "depth_q.qoi")) == hashlib.sha256(
            rgba_encode.encode_qoi(rgba)).hexdigest(),
                  ".ppm": _sha(os.path.join(td, "depth_q.ppm")) == hashlib.sha256(
            rgba_encode.encode_ppm(rgba)).hexdigest()}
        encode_s = {}
        for ext in RAW_DEPTH_EXTS:
            path = os.path.join(td, f"depth_q{ext}")
            t0 = time.perf_counter()
            writers._save_image(path, rgba)
            encode_s[ext] = time.perf_counter() - t0
            want = {".tga": rgba_encode.encode_tga, ".sgi": rgba_encode.encode_sgi,
                    ".im": rgba_encode.encode_im, ".dib": rgba_encode.encode_dib,
                    ".dds": rgba_encode.encode_dds}[ext]
            data = want(rgba, path) if want in writers._NAMED else want(rgba)
            back_mode, back, _ = open_image(path).decode()
            channels = 3 if ext == ".dib" else 4
            checks[ext] = (_sha(path) == hashlib.sha256(data).hexdigest()
                           and back_mode == ("RGB" if ext == ".dib" else "RGBA")
                           and np.array_equal(back, rgba[:, :, :channels]))
        for ext, run in runs.items():
            records[f"{ext[1:]} depth map"] = cli_record(
                f"(q) {ext} depth map", run["seconds"], run["rec"].phases, run["decode"],
                run["launches"], smi, run["encode"],
                **({"encode_s_save_image": {k: round(v, 4) for k, v in encode_s.items()}}
                   if ext == ".qoi" else {}))
        print(f"{label}: {rgba.shape[1]}x{rgba.shape[0]} {mode}; each file the port's writer's"
              f" bytes (read back by the port's readers where written by _save_image) {checks};"
              f" _save_image seconds {json.dumps({k: round(v, 4) for k, v in encode_s.items()})}")
        if mode != "RGBA" or not all(checks.values()):
            raise AssertionError(f"{label}: {[k for k, v in checks.items() if not v]} differ")
        pil = any(m == "PIL" or m.startswith("PIL.") for m in sys.modules)
    print(f"(q) Pillow imported during the runs {pil}; (q) took"
          f" {time.perf_counter() - t_phase:.1f} s")
    if pil:
        raise AssertionError("(q): Pillow was imported")
    return records


# -- phase 8 (r): JPEG 2000 ------------------------------------------------------------


def cli_jpeg2000(cap, smi: str, td: str) -> dict:
    """Phase 8 (r), with every import of Pillow blocked (_NoPillow): the
    committed JPEG 2000 files (J2K_*, tests/gen_torch_formats_fixture.py)
    through cli.main. (r1) the full-width pair as RGB 9/7 JP2 files -> OBJ
    with --focal-length=43 and cli_exif_jpeg_pair's gates but its in-memory
    run (the full-width save twice was most of (r)'s time; (r3) holds a
    JPEG 2000 pair's OBJ to its in-memory run's); (r2) phase 3's
    SEM pair as gray 9/7 codestreams -> PLY, byte-equal to reconstruct's
    on the decoded planes; (r3) BASELINE #3's views as lossless 5/3 RGB
    codestreams -> OBJ with --focal-length=43 and the same gates; the
    decode-only files of every other kind, each timed. Every plane has the
    committed SHA-256 of Pillow's ("jpeg2000"); the decode seconds of each
    plane are printed, and the native decoder's stages (tier-2, tier-1,
    the inverse DWT, the rest) of one file of each pair."""
    from cybervision_tpu_torch import native
    from cybervision_tpu_torch.config import MeshMode, ProjectionMode, ReconstructionConfig
    from cybervision_tpu_torch.imageio import jpeg2000
    from cybervision_tpu_torch.images import SourceImage
    from cybervision_tpu_torch.reconstruction import reconstruct

    with open(FORMATS_SHA256) as fh:
        committed = json.load(fh)["jpeg2000"]
    t_phase = time.perf_counter()
    records = {}

    def load(path):
        """(SourceImage, decode seconds of its gray and colour planes,
        whether both have Pillow's SHA-256)."""
        t0 = time.perf_counter()
        src = SourceImage.load(path)
        rgb_plane = src.load_rgb_plane()
        seconds = time.perf_counter() - t0
        want = committed[os.path.basename(path)]
        return src, seconds, (_plane_sha(src.img) == want["l"]
                              and _plane_sha(rgb_plane) == want["rgb"])

    pairs = {"full": J2K_FULL, "sem": J2K_SEM, "persp": J2K_PERSP}
    with _NoPillow():
        loaded = {kind: [load(p) for p in paths] for kind, paths in pairs.items()}
        seconds = {os.path.basename(p): round(r[1], 4) for kind, paths in pairs.items()
                   for p, r in zip(paths, loaded[kind])}
        hashes = {kind: all(r[2] for r in rs) for kind, rs in loaded.items()}
        print(f"(r) files {[os.path.getsize(p) for p in J2K_FULL + J2K_SEM + J2K_PERSP]} bytes;"
              f" planes equal to Pillow's (SHA-256) {hashes}; decode seconds (gray and colour"
              f" planes) {json.dumps(seconds)}")
        if not all(hashes.values()):
            raise AssertionError("(r): the decoded planes are not Pillow's")
        srcs = {kind: [r[0] for r in rs] for kind, rs in loaded.items()}
        # Where a plane's decode goes: the native decoder's stages of one
        # file of each pair, and the whole decode beside them.
        stages = {}
        for path in (J2K_FULL[0], J2K_SEM[0], J2K_PERSP[0]):
            spent = np.zeros(4)
            with open(path, "rb") as fh:
                data = fh.read()
            t0 = time.perf_counter()
            jpeg2000.decode(jpeg2000.parse(data), native, spent)
            stages[os.path.basename(path)] = {
                "decode": round(time.perf_counter() - t0, 4),
                **{k: round(v, 4) for k, v in zip(("tier-2", "tier-1", "dwt", "rest"), spent)}}
        print(f"(r) one decode's native stages (s): {json.dumps(stages)}")

        w, h = round(PERSP_W * FULL_SCALE), round(PERSP_H * FULL_SCALE)
        records["jp2 97 obj"] = cli_exif_jpeg_pair(
            cap, smi, td, "(r1) RGB 9/7 JP2 pair", f"(r1) RGB 9/7 JP2 pair {w}x{h} -> OBJ",
            J2K_FULL, srcs["full"], {}, (w, h), focal_arg=PERSP_FOCAL_35MM, reference=False)

        label = f"(r2) gray 9/7 codestream pair {SIZE}x{SIZE} -> PLY"
        mem = []
        for s in srcs["sem"]:
            src = SourceImage(s.img)
            src.load_rgb_plane = functools.partial(np.array, s.load_rgb_plane())
            mem.append(src)
        ref, out = os.path.join(td, "mem_r.ply"), os.path.join(td, "r.ply")
        reconstruct(["a", "b"], ref, ReconstructionConfig(
            projection=ProjectionMode.AFFINE, mesh=MeshMode.VERTEX_COLORS), quiet=True,
            images=mem)
        run = cap.main(["--projection=parallel", "--mesh=vertex-colors", *J2K_SEM, out])
        records["j2k 97 ply"] = cli_record("(r2) gray 9/7 codestreams", run["seconds"],
                                           run["rec"].phases, run["decode"], run["launches"], smi)
        same = _sha(out) == _sha(ref)
        print(f"{label}: PLY equal to the in-memory run's (the decoded planes) {same}")
        if not same:
            raise AssertionError(f"{label}: the PLY differs from the in-memory run's")

        records["j2k 53 obj"] = cli_exif_jpeg_pair(
            cap, smi, td, "(r3) lossless 5/3 RGB codestream pair",
            f"(r3) lossless 5/3 RGB codestream pair {PERSP_W}x{PERSP_H} -> OBJ", J2K_PERSP,
            srcs["persp"], {}, (PERSP_W, PERSP_H), focal_arg=PERSP_FOCAL_35MM)

        decode, ok = {}, {}
        for name in J2K_DECODE_ONLY:
            _, decode[name], ok[name] = load(os.path.join(J2K_DIR, name))
        print(f"(r) decoded only: planes equal to Pillow's (SHA-256) {ok}; decode seconds"
              f" {json.dumps({k: round(v, 4) for k, v in decode.items()})}")
        if not all(ok.values()):
            raise AssertionError("(r): the decode-only planes are not Pillow's")
        pil = any(m == "PIL" or m.startswith("PIL.") for m in sys.modules)
    print(f"(r) Pillow imported during the runs {pil}; (r) took"
          f" {time.perf_counter() - t_phase:.1f} s")
    if pil:
        raise AssertionError("(r): Pillow was imported")
    return records


def cli_avif(cap, smi: str, td: str) -> dict:
    """Phase 8 (v), with every import of Pillow blocked (_NoPillow): the
    committed AVIF files (AVIF_*, tests/gen_torch_formats_fixture.py)
    through cli.main. (v1) phase 3's SEM pair as 4:0:0 AVIF -> PLY,
    byte-equal to reconstruct's on the decoded planes; (v2) BASELINE #3's
    views as RGB 4:2:0 AVIF carrying EXIF focal length 43 and orientation
    6 (irot) -> OBJ with no --focal-length and cli_exif_jpeg_pair's gates;
    the decode-only files (RGBA, 4:4:4, limited range, lossless, tiled, a
    sequence), each timed. Every plane has the committed SHA-256 of
    Pillow's ("avif"); the decode seconds of each plane are printed."""
    from cybervision_tpu_torch.config import MeshMode, ProjectionMode, ReconstructionConfig
    from cybervision_tpu_torch.images import SourceImage
    from cybervision_tpu_torch.reconstruction import reconstruct

    with open(FORMATS_SHA256) as fh:
        hashes = json.load(fh)
    committed = {**hashes["avif"], **hashes["avif kinds"]}
    t_phase = time.perf_counter()
    records = {}

    def load(path):
        """(SourceImage, decode seconds of its gray and colour planes,
        whether both have Pillow's SHA-256)."""
        t0 = time.perf_counter()
        src = SourceImage.load(path)
        rgb_plane = src.load_rgb_plane()
        seconds = time.perf_counter() - t0
        want = committed[os.path.basename(path)]
        return src, seconds, (_plane_sha(src.img) == want["l"]
                              and _plane_sha(rgb_plane) == want["rgb"])

    pairs = {"sem": AVIF_SEM, "persp": AVIF_PERSP}
    with _NoPillow():
        loaded = {kind: [load(p) for p in paths] for kind, paths in pairs.items()}
        seconds = {os.path.basename(p): round(r[1], 4) for kind, paths in pairs.items()
                   for p, r in zip(paths, loaded[kind])}
        hashes = {kind: all(r[2] for r in rs) for kind, rs in loaded.items()}
        print(f"(v) files {[os.path.getsize(p) for p in AVIF_SEM + AVIF_PERSP]} bytes; planes"
              f" equal to Pillow's (SHA-256) {hashes}; decode seconds (gray and colour planes)"
              f" {json.dumps(seconds)}")
        if not all(hashes.values()):
            raise AssertionError("(v): the decoded planes are not Pillow's")
        srcs = {kind: [r[0] for r in rs] for kind, rs in loaded.items()}

        label = f"(v1) 4:0:0 AVIF pair {SIZE}x{SIZE} -> PLY"
        mem = []
        for s in srcs["sem"]:
            src = SourceImage(s.img)
            src.load_rgb_plane = functools.partial(np.array, s.load_rgb_plane())
            mem.append(src)
        ref, out = os.path.join(td, "mem_v.ply"), os.path.join(td, "v.ply")
        reconstruct(["a", "b"], ref, ReconstructionConfig(
            projection=ProjectionMode.AFFINE, mesh=MeshMode.VERTEX_COLORS), quiet=True,
            images=mem)
        run = cap.main(["--projection=parallel", "--mesh=vertex-colors", *AVIF_SEM, out])
        records["avif 400 ply"] = cli_record("(v1) 4:0:0 AVIF pair", run["seconds"],
                                             run["rec"].phases, run["decode"], run["launches"],
                                             smi)
        same = _sha(out) == _sha(ref)
        print(f"{label}: PLY equal to the in-memory run's (the decoded planes) {same}")
        if not same:
            raise AssertionError(f"{label}: the PLY differs from the in-memory run's")

        records["avif 420 obj"] = cli_exif_jpeg_pair(
            cap, smi, td, "(v2) RGB 4:2:0 AVIF pair, EXIF focal 43 and orientation 6",
            f"(v2) RGB 4:2:0 AVIF pair {PERSP_W}x{PERSP_H} -> OBJ", AVIF_PERSP,
            srcs["persp"], {"EXIF focal length 43": all(
                s.focal_length_35mm == PERSP_FOCAL_35MM for s in srcs["persp"])},
            (PERSP_W, PERSP_H))

        decode, ok = {}, {}
        for name in AVIF_DECODE_ONLY:
            _, decode[name], ok[name] = load(os.path.join(AVIF_DIR, name))
        print(f"(v) decoded only: planes equal to Pillow's (SHA-256) {ok}; decode seconds"
              f" {json.dumps({k: round(v, 4) for k, v in decode.items()})}")
        if not all(ok.values()):
            raise AssertionError("(v): the decode-only planes are not Pillow's")
        records.update(cli_avif_kinds(cap, smi, td, load))
        pil = any(m == "PIL" or m.startswith("PIL.") for m in sys.modules)
    print(f"(v) Pillow imported during the runs {pil}; (v) took"
          f" {time.perf_counter() - t_phase:.1f} s")
    if pil:
        raise AssertionError("(v): Pillow was imported")
    return records


def cli_avif_kinds(cap, smi: str, td: str, load) -> dict:
    """Phase 8 (v3), inside (v)'s block of Pillow: the kinds the wheel's
    libavif encoder writes (AVIF_GRID_SEM, AVIF_KINDS_*). Phase 3's SEM
    pair as 2x2 grids of 512x512 tiles (4:2:0, matrix coefficients 1,
    quantizer matrices, film grain) decoded to the committed SHA-256 of
    Pillow's planes, then -> PLY through cli.main, byte-equal to
    reconstruct's on the decoded planes; every decode-only file to its
    hashes; every file Pillow fails on refused (ImageError); the decode
    seconds of each kind (grid, quantizer matrices, film grain, matrix
    coefficients) printed with the card. `load` is cli_avif's."""
    from cybervision_tpu_torch.config import MeshMode, ProjectionMode, ReconstructionConfig
    from cybervision_tpu_torch.errors import ImageError
    from cybervision_tpu_torch.images import SourceImage
    from cybervision_tpu_torch.reconstruction import reconstruct

    records = {}
    grid = [load(p) for p in AVIF_GRID_SEM]
    print(f"(v3) grid files {[os.path.getsize(p) for p in AVIF_GRID_SEM]} bytes; planes equal"
          f" to Pillow's (SHA-256) {[r[2] for r in grid]}")
    if not all(r[2] for r in grid):
        raise AssertionError("(v3): the grid pair's planes are not Pillow's")
    label = f"(v3) 2x2 grid AVIF pair {SIZE}x{SIZE} (4:2:0, QM, film grain) -> PLY"
    mem = []
    for s, _, _ in grid:
        src = SourceImage(s.img)
        src.load_rgb_plane = functools.partial(np.array, s.load_rgb_plane())
        mem.append(src)
    ref, out = os.path.join(td, "mem_v3.ply"), os.path.join(td, "v3.ply")
    reconstruct(["a", "b"], ref, ReconstructionConfig(
        projection=ProjectionMode.AFFINE, mesh=MeshMode.VERTEX_COLORS), quiet=True, images=mem)
    run = cap.main(["--projection=parallel", "--mesh=vertex-colors", *AVIF_GRID_SEM, out])
    records["avif grid ply"] = cli_record("(v3) grid AVIF pair", run["seconds"], run["rec"].phases,
                                          run["decode"], run["launches"], smi)
    same = _sha(out) == _sha(ref)
    print(f"{label}: PLY equal to the in-memory run's (the decoded planes) {same}")
    if not same:
        raise AssertionError(f"{label}: the PLY differs from the in-memory run's")

    decode, ok = {}, {}
    for name in AVIF_KINDS_DECODE_ONLY:
        _, decode[name], ok[name] = load(os.path.join(AVIF_DIR, name))
    bad = [n for n, good in ok.items() if not good]
    print(f"(v3) decoded only: {len(ok)} files, planes equal to Pillow's (SHA-256) for"
          f" {len(ok) - len(bad)}; not for {bad}")
    refused = {}
    for name in AVIF_KINDS_FAIL:
        try:
            SourceImage.load(os.path.join(AVIF_DIR, name)).load_rgb_plane()
            refused[name] = False
        except ImageError:
            refused[name] = True
    print(f"(v3) files Pillow fails on, refused {refused}")
    kinds = {"grid stitch (2x2 of 512x512)": [os.path.basename(p) for p in AVIF_GRID_SEM],
             "grid stitch (2x3 of 64x64, alpha)": ["grid_2x3_alpha.avif",
                                                    "grid_2x3_alpha_cropped.avif"],
             "quantizer matrices": [n for n in AVIF_KINDS_DECODE_ONLY if n.startswith("qm")],
             "film grain": [n for n in AVIF_KINDS_DECODE_ONLY if n.startswith("grain")],
             "matrix coefficients": [n for n in AVIF_KINDS_DECODE_ONLY if n.startswith("mc")]}
    seconds = {**{os.path.basename(p): r[1] for p, r in zip(AVIF_GRID_SEM, grid)}, **decode}
    for kind, names in kinds.items():
        secs = [round(seconds[n], 4) for n in names]
        shown = secs if len(secs) <= 5 else f"{len(secs)} files, {min(secs)}-{max(secs)}"
        print(f"(v3) decode seconds, {kind}: {shown} (gray and colour planes); {smi}")
    if bad or not all(refused.values()):
        raise AssertionError("(v3): a decode-only file is not Pillow's, or a file Pillow"
                             " fails on was read")
    return records


def cli_avif_depth(cap, smi: str, td: str) -> dict:
    """Phase 8 (x), with every import of Pillow blocked (_NoPillow): the
    committed 10- and 12-bit AVIF files (AVIF_DEPTH_*,
    tests/gen_torch_formats_fixture.py "avif depth") through cli.main.
    (x1) phase 3's SEM pair as 10-bit 4:0:0 AVIF -> PLY, byte-equal to
    reconstruct's on the decoded planes, K1 8 / K2 1 / K3 1; (x2) BASELINE
    #3's views as 12-bit RGBA 4:2:0 with a premultiplied alpha and EXIF
    focal 43 -> OBJ with no --focal-length and cli_exif_jpeg_pair's gates,
    K1 6 / K2 20 / K3 20. Every plane has the committed SHA-256 of
    Pillow's; the decode seconds of each file are printed."""
    from cybervision_tpu_torch.config import MeshMode, ProjectionMode, ReconstructionConfig
    from cybervision_tpu_torch.images import SourceImage
    from cybervision_tpu_torch.reconstruction import reconstruct

    with open(FORMATS_SHA256) as fh:
        committed = json.load(fh)["avif depth"]
    t_phase = time.perf_counter()
    records = {}

    def check_launches(label, launches, want):
        got = tuple(launches.get(n, 0) for n in ("ncc_sweep", "score_candidates",
                                                  "gather_packed"))
        print(f"{label}: launches K1 / K2 / K3 {got}, expected {want}")
        if got != want:
            raise AssertionError(f"{label}: launches {got}, not {want}")

    with _NoPillow():
        loaded = {}
        for path in AVIF_DEPTH_SEM + AVIF_DEPTH_PERSP:
            t0 = time.perf_counter()
            src = SourceImage.load(path)
            rgb_plane = src.load_rgb_plane()
            want = committed[os.path.basename(path)]
            loaded[path] = (src, time.perf_counter() - t0, _plane_sha(src.img) == want["l"]
                            and _plane_sha(rgb_plane) == want["rgb"])
        for path, (_, secs, ok) in loaded.items():
            print(f"(x) {os.path.basename(path)}: {os.path.getsize(path)} bytes, decode"
                  f" {secs:.4f} s (gray and colour planes), planes equal to Pillow's (SHA-256)"
                  f" {ok}")
        if not all(r[2] for r in loaded.values()):
            raise AssertionError("(x): the decoded planes are not Pillow's")

        label = f"(x1) 10-bit 4:0:0 AVIF pair {SIZE}x{SIZE} -> PLY"
        mem = []
        for path in AVIF_DEPTH_SEM:
            s = loaded[path][0]
            src = SourceImage(s.img)
            src.load_rgb_plane = functools.partial(np.array, s.load_rgb_plane())
            mem.append(src)
        ref, out = os.path.join(td, "mem_x.ply"), os.path.join(td, "x.ply")
        reconstruct(["a", "b"], ref, ReconstructionConfig(
            projection=ProjectionMode.AFFINE, mesh=MeshMode.VERTEX_COLORS), quiet=True,
            images=mem)
        run = cap.main(["--projection=parallel", "--mesh=vertex-colors", *AVIF_DEPTH_SEM, out])
        records["avif 10-bit ply"] = cli_record("(x1) 10-bit 4:0:0 AVIF pair", run["seconds"],
                                                run["rec"].phases, run["decode"],
                                                run["launches"], smi)
        check_launches(label, run["launches"], (8, 1, 1))
        same = _sha(out) == _sha(ref)
        print(f"{label}: PLY equal to the in-memory run's (the decoded planes) {same}")
        if not same:
            raise AssertionError(f"{label}: the PLY differs from the in-memory run's")

        srcs = [loaded[p][0] for p in AVIF_DEPTH_PERSP]
        label = f"(x2) 12-bit premultiplied RGBA 4:2:0 AVIF pair {PERSP_W}x{PERSP_H} -> OBJ"
        records["avif 12-bit prem obj"] = cli_exif_jpeg_pair(
            cap, smi, td, "(x2) 12-bit premultiplied RGBA 4:2:0 AVIF pair, EXIF focal 43", label,
            AVIF_DEPTH_PERSP, srcs, {"EXIF focal length 43": all(
                s.focal_length_35mm == PERSP_FOCAL_35MM for s in srcs)}, (PERSP_W, PERSP_H))
        check_launches(label, records["avif 12-bit prem obj"]["launches"], (6, 20, 20))
        pil = any(m == "PIL" or m.startswith("PIL.") for m in sys.modules)
    print(f"(x) Pillow imported during the runs {pil}; (x) took"
          f" {time.perf_counter() - t_phase:.1f} s")
    if pil:
        raise AssertionError("(x): Pillow was imported")
    return records


def cli_avif_scale(cap, smi: str, td: str) -> dict:
    """Phase 8 (y), with every import of Pillow blocked (_NoPillow): the
    committed superres and scaled AVIF files (AVIF_SUPERRES_SEM,
    AVIF_SCALE_*, tests/gen_torch_formats_fixture.py "avif scale"). (y1)
    phase 3's SEM pair coded at AVIF_SUPERRES_CODED columns and upscaled
    by superres to SIZE -> PLY, byte-equal to reconstruct's on the decoded
    planes, K1 8 / K2 1 / K3 1; the small superres and scaled files
    decoded, the one whose frame libyuv cannot scale refused; every plane
    to the committed SHA-256 of Pillow's. (y2) one in-memory run of a
    SIZE / 4 SEM pair with CVTPU_PROFILE set (Reconstruction.run's
    torch.profiler trace, outside the script's own profiled runs), whose
    trace file must name K1's kernel."""
    from cybervision_tpu_torch.config import MeshMode, ProjectionMode, ReconstructionConfig
    from cybervision_tpu_torch.images import SourceImage
    from cybervision_tpu_torch.ops import ncc_sweep
    from cybervision_tpu_torch.reconstruction import reconstruct

    with open(FORMATS_SHA256) as fh:
        committed = json.load(fh)["avif scale"]
    t_phase = time.perf_counter()
    records = {}
    with _NoPillow():
        loaded, decode = {}, {}
        for path in AVIF_SUPERRES_SEM + [os.path.join(AVIF_DIR, n)
                                         for n in AVIF_SCALE_DECODE_ONLY]:
            t0 = time.perf_counter()
            src = SourceImage.load(path)
            rgb_plane = src.load_rgb_plane()
            want = committed[os.path.basename(path)]
            loaded[path] = src
            decode[os.path.basename(path)] = (round(time.perf_counter() - t0, 4),
                                              _plane_sha(src.img) == want["l"]
                                              and _plane_sha(rgb_plane) == want["rgb"])
        refused = {}
        for name in AVIF_SCALE_FAIL:
            try:
                SourceImage.load(os.path.join(AVIF_DIR, name)).load_rgb_plane()
                refused[name] = "read"
            except Exception as err:  # noqa: BLE001 - the refusal is the result
                refused[name] = str(err)
        print(f"(y) {len(decode)} files, (decode seconds, planes equal to Pillow's) {decode};"
              f" refused {refused}")
        if not all(ok for _, ok in decode.values()):
            raise AssertionError("(y): the decoded planes are not Pillow's")
        if any(why == "read" or "libyuv" not in why for why in refused.values()):
            raise AssertionError("(y): a size libavif refuses to scale was read")

        label = (f"(y1) superres 4:0:0 AVIF pair {SIZE}x{SIZE} coded at"
                 f" {AVIF_SUPERRES_CODED} columns -> PLY")
        mem = []
        for path in AVIF_SUPERRES_SEM:
            src = SourceImage(loaded[path].img)
            src.load_rgb_plane = functools.partial(np.array, loaded[path].load_rgb_plane())
            mem.append(src)
        ref, out = os.path.join(td, "mem_y.ply"), os.path.join(td, "y.ply")
        reconstruct(["a", "b"], ref, ReconstructionConfig(
            projection=ProjectionMode.AFFINE, mesh=MeshMode.VERTEX_COLORS), quiet=True,
            images=mem)
        run = cap.main(["--projection=parallel", "--mesh=vertex-colors", *AVIF_SUPERRES_SEM, out])
        records["avif superres ply"] = cli_record("(y1) superres 4:0:0 AVIF pair", run["seconds"],
                                                  run["rec"].phases, run["decode"],
                                                  run["launches"], smi)
        got = tuple(run["launches"].get(n, 0) for n in ("ncc_sweep", "score_candidates",
                                                         "gather_packed"))
        same = _sha(out) == _sha(ref)
        print(f"{label}: launches K1 / K2 / K3 {got}, expected (8, 1, 1); PLY equal to the"
              f" in-memory run's (the decoded planes) {same}")
        if got != (8, 1, 1) or not same:
            raise AssertionError(f"{label}: launches {got} or the PLY differs")

        label = f"(y2) CVTPU_PROFILE on a {SIZE // 4}x{SIZE // 4} SEM pair, in memory"
        img1, img2, _ = synth_sem_pair(SIZE // 4, SIZE // 4)
        trace_dir = os.path.join(td, "trace")
        old = os.environ.get("CVTPU_PROFILE")
        os.environ["CVTPU_PROFILE"] = trace_dir
        ncc_sweep.launches = 0
        t0 = time.perf_counter()
        try:
            reconstruct(["a", "b"], os.path.join(td, "profiled.ply"), ReconstructionConfig(
                projection=ProjectionMode.AFFINE), quiet=True,
                images=[SourceImage(im) for im in (img1, img2)])
        finally:
            if old is None:
                del os.environ["CVTPU_PROFILE"]
            else:
                os.environ["CVTPU_PROFILE"] = old
        seconds = time.perf_counter() - t0
        traces = [os.path.join(trace_dir, n) for n in os.listdir(trace_dir)]
        kernels = set()
        for path in traces:
            with open(path) as fh:
                kernels |= {e.get("name", "") for e in json.load(fh)["traceEvents"]
                            if e.get("cat") == "kernel"}
        k1 = sorted(k for k in kernels if any(n in k for n in KERNEL_NAMES["ncc_sweep"]))
        print(f"{label}: {seconds:.3f} s with the trace; {len(traces)} trace file(s),"
              f" {sum(os.path.getsize(p) for p in traces)} bytes, {len(kernels)} kernel names;"
              f" K1 launched {ncc_sweep.launches} times, its kernels in the trace {k1}")
        if len(traces) != 1 or not k1 or not ncc_sweep.launches:
            raise AssertionError(f"{label}: the trace does not name K1's kernel")
        pil = any(m == "PIL" or m.startswith("PIL.") for m in sys.modules)
    print(f"(y) Pillow imported during the runs {pil}; (y) took"
          f" {time.perf_counter() - t_phase:.1f} s")
    if pil:
        raise AssertionError("(y): Pillow was imported")
    return records


# -- phase 8 (s): Pillow's PNG, GIF, ICO and ICNS depth-map writers -------------------

DEPTH_WRITER_EXTS = (".png", ".apng", ".gif", ".ico", ".icns")


def depth_writer_rgba(h: int = 260, w: int = 300, seed: int = 23) -> np.ndarray:
    """A seeded viridis depth map as the writers receive it (numpy and the
    port's colour map): a smooth surface with a little noise, transparent
    in blobs and at scattered pixels (about a quarter), those pixels the
    colour map's first entry. tests/gen_torch_formats_fixture.py commits
    the SHA-256 of Pillow's bytes of it for each of DEPTH_WRITER_EXTS."""
    from cybervision_tpu_torch.output.colormap import map_depth

    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    d = np.sin(x / 9.0) + np.cos(y / 6.0) + 0.02 * rng.rand(h, w)
    d = (d - d.min()) / max(d.max() - d.min(), 1e-9)
    blobs = np.sin(x / 13.0 + 1.0) * np.cos(y / 11.0) + 0.1 * rng.rand(h, w)
    filled = (blobs < 0.48) & (rng.rand(h, w) >= 0.05)
    rgba = np.zeros((h, w, 4), np.uint8)
    rgba[:, :, :3] = map_depth(np.where(filled, d, 0.0))
    rgba[:, :, 3] = np.where(filled, 255, 0)
    return rgba


def _png_deflate_free(data: bytes) -> bytes:
    """A PNG's signature and chunks other than IDAT as written, then its
    IDAT data inflated."""
    pos, out, idat = 8, [data[:8]], []
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos : pos + 8])
        if kind == b"IDAT":
            idat.append(data[pos + 8 : pos + 8 + n])
        else:
            out.append(data[pos : pos + 12 + n])
        pos += 12 + n
    return b"".join(out) + zlib.decompress(b"".join(idat))


def deflate_free(ext: str, data: bytes) -> bytes:
    """`data` with every deflate stream inflated and the lengths and
    offsets that follow from the streams' sizes left out: what holds a
    PNG-bearing file where zlib differs from the one that made the
    committed hashes. A GIF has no deflate stream."""
    if ext in (".png", ".apng"):
        return _png_deflate_free(data)
    if ext == ".ico":
        (n,) = struct.unpack("<H", data[4:6])
        out = [data[:6]]
        for k in range(n):
            entry = data[6 + 16 * k : 22 + 16 * k]
            size, offset = struct.unpack("<II", entry[8:])
            out += [entry[:8], _png_deflate_free(data[offset : offset + size])]
        return b"".join(out)
    if ext == ".icns":
        out, pos = [data[:4]], 8
        while pos < len(data):
            kind, n = struct.unpack(">4si", data[pos : pos + 8])
            out.append(kind)
            if kind != b"TOC ":
                out.append(_png_deflate_free(data[pos + 8 : pos + n]))
            pos += n
        return b"".join(out)
    return data


def cli_depth_writers(cap, smi: str, td: str, tifs: list[str], mem, texture: np.ndarray) -> dict:
    """Phase 8 (s), with every import of Pillow blocked (_NoPillow): (a)'s
    SEM TIFF pair -> .gif depth map through cli.main, byte-equal to
    reconstruct's on the same planes; the RGBA that run's writer received
    through writers._save_image to .png, .apng, .ico and .icns, each
    encode-and-write timed and read back by the port's readers; the
    seeded depth_writer_rgba() through all five writers against the
    committed SHA-256 of Pillow's bytes (the zlib rule of deflate_free);
    the encode of a 1024x1024 depth map and of BASELINE #4's texture."""
    from cybervision_tpu_torch.config import (
        InterpolationMode, ProjectionMode, ReconstructionConfig,
    )
    from cybervision_tpu_torch.imageio import open_image, png_encode, quantize, resample
    from cybervision_tpu_torch.output import writers
    from cybervision_tpu_torch.reconstruction import reconstruct

    with open(FORMATS_SHA256) as fh:
        committed = json.load(fh)["depth writers"]
    t_phase = time.perf_counter()
    label = f"(s) SEM TIFF pair {SIZE}x{SIZE}+{SEM_DATABAR} -> GIF depth map"
    records = {}
    with _NoPillow():
        ref, out = os.path.join(td, "mem_s.gif"), os.path.join(td, "depth_s.gif")
        kept, save = [], writers._save_image

        def keep(path, rgba):
            kept.append(np.array(rgba))
            save(path, rgba)

        writers._save_image = keep
        try:
            reconstruct(["a", "b"], ref, ReconstructionConfig(
                projection=ProjectionMode.AFFINE, interpolation=InterpolationMode.NONE),
                quiet=True, images=mem)
        finally:
            writers._save_image = save
        (rgba,) = kept
        run = cap.main(["--projection=parallel", "--interpolation=none", *tifs, out])
        same = _sha(out) == _sha(ref)
        index, palette = quantize.adaptive_palette(rgba)
        mode, back, file_palette = open_image(out).decode()
        gif_back = (mode == "P" and back.shape == index.shape
                    and np.array_equal(file_palette[back], palette[index][:, :, :3]))
        print(f"{label}: {rgba.shape[1]}x{rgba.shape[0]}, {os.path.getsize(out)} bytes, equal to"
              f" the in-memory run's {same}; read back to the octree palette's colours"
              f" {gif_back}")
        if not same or not gif_back:
            raise AssertionError(f"{label}: the GIF differs from the in-memory run's or does not"
                                 " read back")

        h, w = rgba.shape[:2]
        icon = max(s for s in (16, 24, 32, 48, 64, 128, 256) if s <= min(h, w))
        want = {".png": rgba, ".apng": rgba,
                ".ico": resample.thumbnail(rgba, (icon, icon), resample.LANCZOS),
                ".icns": resample.resize(rgba, (1024, 1024))}
        encode_s, back_ok = {}, {}
        for ext in (".png", ".apng", ".ico", ".icns"):
            path = os.path.join(td, f"depth_s{ext}")
            t0 = time.perf_counter()
            writers._save_image(path, rgba)
            encode_s[ext] = time.perf_counter() - t0
            mode, back, _ = open_image(path).decode()
            back_ok[ext] = mode == "RGBA" and np.array_equal(back, want[ext])
        print(f"(s) the RGBA through _save_image: read back by the port's readers {back_ok};"
              f" encode-and-write seconds {json.dumps({k: round(v, 4) for k, v in encode_s.items()})}"
              f" ({smi})")
        if not all(back_ok.values()):
            raise AssertionError(f"(s): {[k for k, v in back_ok.items() if not v]} do not read back")

        seeded = depth_writer_rgba()
        zlib_same = zlib.ZLIB_RUNTIME_VERSION == committed["zlib"]
        hashes, encode_seeded = {}, {}
        for ext in DEPTH_WRITER_EXTS:
            path = os.path.join(td, f"seeded{ext}")
            t0 = time.perf_counter()
            writers._save_image(path, seeded)
            encode_seeded[ext] = time.perf_counter() - t0
            with open(path, "rb") as fh:
                data = fh.read()
            want_sha = committed["files"][ext]
            as_bytes = hashlib.sha256(data).hexdigest() == want_sha["bytes"]
            as_free = hashlib.sha256(deflate_free(ext, data)).hexdigest() == want_sha["deflate free"]
            hashes[ext] = {"bytes": as_bytes, "deflate free": as_free,
                           "held": as_bytes if zlib_same or ext == ".gif" else as_free}
        held_by = ("the bytes" if zlib_same else
                   f"the bytes for .gif, the inflated IDAT data and the bytes outside the deflate"
                   f" streams for the rest (zlib {zlib.ZLIB_RUNTIME_VERSION} here, the hashes"
                   f" made with {committed['zlib']})")
        print(f"(s) seeded {seeded.shape[1]}x{seeded.shape[0]} map: equal to Pillow's (SHA-256,"
              f" held by {held_by}) {json.dumps(hashes)}; C library"
              f" {os.confstr('CS_GNU_LIBC_VERSION')} (the hashes made with {committed['libc']});"
              f" encode-and-write seconds"
              f" {json.dumps({k: round(v, 4) for k, v in encode_seeded.items()})}")
        if not all(v["held"] for v in hashes.values()):
            raise AssertionError(f"(s): {[k for k, v in hashes.items() if not v['held']]} are"
                                 " not Pillow's")

        timed = {f"{SIZE}x{SIZE} depth map (.png, level {png_encode.DEFAULT_LEVEL})":
                 (depth_writer_rgba(SIZE, SIZE), png_encode.DEFAULT_LEVEL),
                 f"BASELINE #4 texture {LARGE_W}x{LARGE_H} (level {writers.TEXTURE_PNG_LEVEL})":
                 (texture, writers.TEXTURE_PNG_LEVEL)}
        encode_png_s = {}
        for name, (px, level) in timed.items():
            runs = []
            for _ in range(3):
                t0 = time.perf_counter()
                n = len(png_encode.encode_png(px, level))
                runs.append(time.perf_counter() - t0)
            encode_png_s[name] = min(runs)
            print(f"(s) encode_png of the {name}: {min(runs):.4f} s (best of 3), {n} bytes")
        records["gif depth map"] = cli_record(
            "(s) GIF depth map", run["seconds"], run["rec"].phases, run["decode"],
            run["launches"], smi, run["encode"],
            encode_s_save_image={k: round(v, 4) for k, v in encode_s.items()},
            encode_s_png={k: round(v, 4) for k, v in encode_png_s.items()},
            zlib=zlib.ZLIB_RUNTIME_VERSION)
        pil = any(m == "PIL" or m.startswith("PIL.") for m in sys.modules)
    print(f"(s) Pillow imported during the runs {pil}; (s) took"
          f" {time.perf_counter() - t_phase:.1f} s")
    if pil:
        raise AssertionError("(s): Pillow was imported")
    return records


# -- phase 8 (t): the lossless JPEG 2000 and PDF depth-map writers --------------------

J2K_WRITER_EXTS = (".jp2", ".j2k", ".j2c", ".jpc", ".jpf", ".jpx", ".pdf")
# time.gmtime() while the seeded PDF's committed hash was made (its dates).
PDF_CLOCK = (2026, 1, 2, 3, 4, 5, 4, 2, 0)


@contextlib.contextmanager
def fixed_clock():
    """time.gmtime() gives PDF_CLOCK while the block runs: the dates the
    PDF writers (Pillow's and the port's) put in the file."""
    real = time.gmtime
    time.gmtime = lambda *args: time.struct_time(PDF_CLOCK)
    try:
        yield
    finally:
        time.gmtime = real


def pdf_jp2(data: bytes) -> bytes:
    """The JP2 file that Pillow's one-page PDF of an RGBA image holds as
    its image's stream (/JPXDecode)."""
    at = data.index(b"/JPXDecode")
    length = data.index(b"/Length ", at) + 8
    n = int(data[length:data.index(b"\n", length)])
    start = data.index(b">>stream\n", at) + 9
    return data[start:start + n]


def cli_jpeg2000_writers(cap, smi: str, td: str, tifs: list[str], mem) -> dict:
    """Phase 8 (t), with every import of Pillow blocked (_NoPillow): (a)'s
    SEM TIFF pair -> .jp2 depth map through cli.main, byte-equal to
    reconstruct's on the same planes and read back by the port's JPEG 2000
    decoder to the RGBA that run's writer received; that RGBA through
    writers._save_image to .j2k, .j2c, .jpc, .jpf, .jpx and .pdf, each
    encode-and-write timed and read back (the PDF's JP2 stream) to it; the
    seeded depth_writer_rgba() through the seven writers against the
    committed SHA-256 of Pillow's bytes ("jpeg2000 writer", the PDF at
    PDF_CLOCK); the encode of an 898x1014 and a 1024x1024 depth map timed,
    best of 3."""
    from cybervision_tpu_torch.config import (
        InterpolationMode, ProjectionMode, ReconstructionConfig,
    )
    from cybervision_tpu_torch.imageio import ImageFile, identify, jpeg2000_encode
    from cybervision_tpu_torch.output import writers
    from cybervision_tpu_torch.reconstruction import reconstruct

    def read_back(data: bytes) -> np.ndarray | None:
        mode, px, _ = ImageFile(*identify(data)).decode()
        return px if mode == "RGBA" else None

    with open(FORMATS_SHA256) as fh:
        committed = json.load(fh)["jpeg2000 writer"]
    t_phase = time.perf_counter()
    label = f"(t) SEM TIFF pair {SIZE}x{SIZE}+{SEM_DATABAR} -> JPEG 2000 depth map"
    records = {}
    with _NoPillow():
        ref, out = os.path.join(td, "mem_t.jp2"), os.path.join(td, "depth.jp2")
        kept, save = [], writers._save_image

        def keep(path, rgba):
            kept.append(np.array(rgba))
            save(path, rgba)

        writers._save_image = keep
        try:
            reconstruct(["a", "b"], ref, ReconstructionConfig(
                projection=ProjectionMode.AFFINE, interpolation=InterpolationMode.NONE),
                quiet=True, images=mem)
        finally:
            writers._save_image = save
        (rgba,) = kept
        run = cap.main(["--projection=parallel", "--interpolation=none", *tifs, out])
        same = _sha(out) == _sha(ref)
        with open(out, "rb") as fh:
            back = read_back(fh.read())
        jp2_back = back is not None and np.array_equal(back, rgba)
        print(f"{label}: {rgba.shape[1]}x{rgba.shape[0]}, {os.path.getsize(out)} bytes, equal to"
              f" the in-memory run's {same}; read back to its RGBA {jp2_back}")
        if not same or not jp2_back:
            raise AssertionError(f"{label}: the JP2 differs from the in-memory run's or does not"
                                 " read back")

        encode_s, back_ok = {}, {}
        for ext in J2K_WRITER_EXTS[1:]:
            path = os.path.join(td, f"depth_t{ext}")
            t0 = time.perf_counter()
            writers._save_image(path, rgba)
            encode_s[ext] = time.perf_counter() - t0
            with open(path, "rb") as fh:
                data = fh.read()
            px = read_back(pdf_jp2(data) if ext == ".pdf" else data)
            back_ok[ext] = px is not None and np.array_equal(px, rgba)
        print(f"(t) the RGBA through _save_image: read back by the port's decoder {back_ok};"
              f" encode-and-write seconds {json.dumps({k: round(v, 4) for k, v in encode_s.items()})}"
              f" ({smi})")
        if not all(back_ok.values()):
            raise AssertionError(f"(t): {[k for k, v in back_ok.items() if not v]} do not read back")

        seeded = depth_writer_rgba()
        hashes = {}
        with fixed_clock():
            for ext in J2K_WRITER_EXTS:
                path = os.path.join(td, f"seeded{ext}")
                writers._save_image(path, seeded)
                hashes[ext] = _sha(path) == committed[ext]
        print(f"(t) seeded {seeded.shape[1]}x{seeded.shape[0]} map: equal to Pillow's (SHA-256)"
              f" {json.dumps(hashes)}")
        if not all(hashes.values()):
            raise AssertionError(f"(t): {[k for k, v in hashes.items() if not v]} are not"
                                 " Pillow's")

        encode_jp2_s = {}
        for h, w in ((1014, 898), (SIZE, SIZE)):
            px, runs = depth_writer_rgba(h, w), []
            for _ in range(3):
                t0 = time.perf_counter()
                n = len(jpeg2000_encode.encode_jp2(px))
                runs.append(time.perf_counter() - t0)
            encode_jp2_s[f"{w}x{h}"] = min(runs)
            print(f"(t) encode_jp2 of a {w}x{h} depth map: {min(runs):.4f} s (best of 3),"
                  f" {n} bytes ({os.cpu_count()} CPUs)")
        records["jp2 depth map"] = cli_record(
            "(t) JPEG 2000 depth map", run["seconds"], run["rec"].phases, run["decode"],
            run["launches"], smi, run["encode"],
            encode_s_save_image={k: round(v, 4) for k, v in encode_s.items()},
            encode_s_jp2={k: round(v, 4) for k, v in encode_jp2_s.items()})
        pil = any(m == "PIL" or m.startswith("PIL.") for m in sys.modules)
    print(f"(t) Pillow imported during the runs {pil}; (t) took"
          f" {time.perf_counter() - t_phase:.1f} s")
    if pil:
        raise AssertionError("(t): Pillow was imported")
    return records


# -- phase 8 (u): the lossy WebP depth-map writer ------------------------------------

WEBP_WRITER_MAPS = ("seeded", "opaque", "clear")  # phase 8 (u)'s committed maps


def webp_writer_maps() -> dict:
    """depth_writer_rgba()'s seeded map, an opaque copy (alpha 255: one
    VP8 chunk) and a fully transparent copy, by WEBP_WRITER_MAPS name.
    tests/gen_torch_formats_fixture.py commits the SHA-256 of Pillow's
    .webp bytes of each ("webp writer")."""
    seeded = depth_writer_rgba()
    opaque, clear = seeded.copy(), seeded.copy()
    opaque[:, :, 3] = 255
    clear[:, :, 3] = 0
    return {"seeded": seeded, "opaque": opaque, "clear": clear}


def cli_webp_writer(cap, smi: str, td: str, tifs: list[str], mem) -> dict:
    """Phase 8 (u), with every import of Pillow blocked (_NoPillow): (a)'s
    SEM TIFF pair -> .webp depth map through cli.main, byte-equal to
    reconstruct's on the same planes and read back by the port's WebP
    reader: the alpha the RGBA that run's writer received, exactly, its
    RGB the lossy decode (mean error on the opaque pixels under 4); the
    seeded maps of webp_writer_maps() through writers._save_image against
    the committed SHA-256 of Pillow's bytes ("webp writer"); the encode
    of an 898x1014 and a 1024x1024 depth map timed, best of 3."""
    from cybervision_tpu_torch.config import (
        InterpolationMode, ProjectionMode, ReconstructionConfig,
    )
    from cybervision_tpu_torch.imageio import ImageFile, identify, webp_encode
    from cybervision_tpu_torch.output import writers
    from cybervision_tpu_torch.reconstruction import reconstruct

    with open(FORMATS_SHA256) as fh:
        committed = json.load(fh)["webp writer"]
    t_phase = time.perf_counter()
    label = f"(u) SEM TIFF pair {SIZE}x{SIZE}+{SEM_DATABAR} -> WebP depth map"
    records = {}
    with _NoPillow():
        ref, out = os.path.join(td, "mem_u.webp"), os.path.join(td, "depth.webp")
        kept, save = [], writers._save_image

        def keep(path, rgba):
            kept.append(np.array(rgba))
            save(path, rgba)

        writers._save_image = keep
        try:
            reconstruct(["a", "b"], ref, ReconstructionConfig(
                projection=ProjectionMode.AFFINE, interpolation=InterpolationMode.NONE),
                quiet=True, images=mem)
        finally:
            writers._save_image = save
        (rgba,) = kept
        run = cap.main(["--projection=parallel", "--interpolation=none", *tifs, out])
        same = _sha(out) == _sha(ref)
        with open(out, "rb") as fh:
            mode, back, _ = ImageFile(*identify(fh.read())).decode()
        alpha_back = mode == "RGBA" and np.array_equal(back[:, :, 3], rgba[:, :, 3])
        opaque = rgba[:, :, 3] == 255
        err = np.abs(back[:, :, :3].astype(np.int32) - rgba[:, :, :3])[opaque]
        drift = float(err.mean()) if err.size else 0.0
        print(f"{label}: {rgba.shape[1]}x{rgba.shape[0]}, {os.path.getsize(out)} bytes, equal to"
              f" the in-memory run's {same}; alpha read back exactly {alpha_back}; RGB mean"
              f" error on the opaque pixels {drift:.3f}, max {int(err.max()) if err.size else 0}")
        if not same or not alpha_back or drift >= 4.0:
            raise AssertionError(f"{label}: the WebP differs from the in-memory run's or does not"
                                 " read back")

        hashes, maps = {}, webp_writer_maps()
        for name, px in maps.items():
            path = os.path.join(td, f"seeded_{name}.webp")
            writers._save_image(path, px)
            hashes[name] = _sha(path) == committed[name]
        h, w = maps["seeded"].shape[:2]
        print(f"(u) seeded {w}x{h} maps: equal to Pillow's (SHA-256) {json.dumps(hashes)}")
        if not all(hashes.values()):
            raise AssertionError(f"(u): {[k for k, v in hashes.items() if not v]} are not"
                                 " Pillow's")

        encode_s = {}
        for h, w in ((1014, 898), (SIZE, SIZE)):
            px, runs = depth_writer_rgba(h, w), []
            for _ in range(3):
                t0 = time.perf_counter()
                n = len(webp_encode.encode_webp(px))
                runs.append(time.perf_counter() - t0)
            encode_s[f"{w}x{h}"] = min(runs)
            print(f"(u) encode_webp of a {w}x{h} depth map: {min(runs):.4f} s (best of 3),"
                  f" {n} bytes ({os.cpu_count()} CPUs)")
        records["webp depth map"] = cli_record(
            "(u) WebP depth map", run["seconds"], run["rec"].phases, run["decode"],
            run["launches"], smi, run["encode"],
            encode_s_webp={k: round(v, 4) for k, v in encode_s.items()})
        pil = any(m == "PIL" or m.startswith("PIL.") for m in sys.modules)
    print(f"(u) Pillow imported during the runs {pil}; (u) took"
          f" {time.perf_counter() - t_phase:.1f} s")
    if pil:
        raise AssertionError("(u): Pillow was imported")
    return records


# -- phase 8 (w): the AVIF depth-map writer -------------------------------------------

AVIF_WRITER_MAPS = ("seeded", "opaque", "clear")  # phase 8 (w)'s committed maps
AVIF_PSNR_GAP_DB = 1.0  # (g): the PSNR on the opaque pixels at most this under Pillow's
AVIF_SIZE_RATIO = 2.0  # (g): the file at most this many times Pillow's bytes
# (w)'s CLI map: its colour PSNR on the opaque pixels at least this, (g)'s
# bound on Pillow's file of the map rounded down: Pillow's 39.676 dB and
# the port's 39.507 dB on the CPU's reconstruction of (a)'s pair
# (tools/avif_encode_times.py --cli-map, 8 CPUs, Pillow 12.1.0).
AVIF_CLI_PSNR_FLOOR_DB = 38.6


def avif_writer_maps() -> dict:
    """Phase 8 (w)'s maps: webp_writer_maps()'s seeded, opaque and fully
    transparent copies, by AVIF_WRITER_MAPS name.
    tests/gen_torch_formats_fixture.py commits the SHA-256 of the port's
    .avif of each, and Pillow's PSNR on its opaque pixels and its bytes
    ("avif writer")."""
    return webp_writer_maps()


def psnr_opaque(rgba: np.ndarray, back: np.ndarray) -> float:
    """The PSNR of back's RGB against rgba's where rgba's alpha is 255."""
    opaque = rgba[:, :, 3] == 255
    err = (rgba[:, :, :3].astype(np.float64) - back[:, :, :3])[opaque]
    return float(10 * np.log10(255.0**2 / max(float(np.mean(err**2)), 1e-12)))


def cli_avif_writer(cap, smi: str, td: str, tifs: list[str], mem) -> dict:
    """Phase 8 (w), with every import of Pillow blocked (_NoPillow): (a)'s
    SEM TIFF pair -> .avif depth map through cli.main, byte-equal to
    reconstruct's on the same planes and read back by the port's AVIF
    reader: the alpha the RGBA that run's writer received, exactly, its
    colour at AVIF_CLI_PSNR_FLOOR_DB or above; the maps of
    avif_writer_maps() through writers._save_image to .avif and .avifs,
    each with the committed SHA-256 ("avif writer") and held to (g)
    against the committed Pillow PSNR and bytes; encode_avif of an
    898x1014 and a 1024x1024 depth map timed, best of 3."""
    from cybervision_tpu_torch.config import (
        InterpolationMode, ProjectionMode, ReconstructionConfig,
    )
    from cybervision_tpu_torch.imageio import ImageFile, avif_encode, identify
    from cybervision_tpu_torch.output import writers
    from cybervision_tpu_torch.reconstruction import reconstruct

    with open(FORMATS_SHA256) as fh:
        committed = json.load(fh)["avif writer"]
    t_phase = time.perf_counter()
    label = f"(w) SEM TIFF pair {SIZE}x{SIZE}+{SEM_DATABAR} -> AVIF depth map"
    records = {}

    def read_rgba(path):
        with open(path, "rb") as fh:
            mode, back, _ = ImageFile(*identify(fh.read())).decode()
        if mode == "RGB":
            back = np.concatenate([back, np.full(back.shape[:2] + (1,), 255, np.uint8)], axis=2)
        return back

    with _NoPillow():
        ref, out = os.path.join(td, "mem_w.avif"), os.path.join(td, "depth.avif")
        kept, save = [], writers._save_image

        def keep(path, rgba):
            kept.append(np.array(rgba))
            save(path, rgba)

        writers._save_image = keep
        try:
            reconstruct(["a", "b"], ref, ReconstructionConfig(
                projection=ProjectionMode.AFFINE, interpolation=InterpolationMode.NONE),
                quiet=True, images=mem)
        finally:
            writers._save_image = save
        (rgba,) = kept
        run = cap.main(["--projection=parallel", "--interpolation=none", *tifs, out])
        same = _sha(out) == _sha(ref)
        back = read_rgba(out)
        alpha_back = np.array_equal(back[:, :, 3], rgba[:, :, 3])
        psnr = psnr_opaque(rgba, back)
        print(f"{label}: {rgba.shape[1]}x{rgba.shape[0]}, {os.path.getsize(out)} bytes, equal to"
              f" the in-memory run's {same}; alpha read back exactly {alpha_back}; PSNR on the"
              f" opaque pixels {psnr:.3f} dB (floor {AVIF_CLI_PSNR_FLOOR_DB})")
        if not same or not alpha_back or psnr < AVIF_CLI_PSNR_FLOOR_DB:
            raise AssertionError(f"{label}: the AVIF differs from the in-memory run's or does not"
                                 " read back")

        gates, measured = {}, {}
        for name, px in avif_writer_maps().items():
            want = committed[name]
            for ext in (".avif", ".avifs"):
                path = os.path.join(td, f"seeded_{name}{ext}")
                writers._save_image(path, px)
                back = read_rgba(path)
                size = os.path.getsize(path)
                ok = (_sha(path) == want["sha256"] and np.array_equal(back[:, :, 3], px[:, :, 3])
                      and size <= AVIF_SIZE_RATIO * want["pillow_bytes"])
                row = {"bytes": size, "pillow_bytes": want["pillow_bytes"]}
                if (px[:, :, 3] == 255).any():
                    row["psnr"] = round(psnr_opaque(px, back), 4)
                    row["pillow_psnr"] = round(want["pillow_psnr"], 4)
                    ok = ok and row["psnr"] >= want["pillow_psnr"] - AVIF_PSNR_GAP_DB
                gates[f"{name}{ext}"] = ok
                measured[name] = row
        print(f"(w) seeded maps: the committed SHA-256, the alpha back exactly and (g) held"
              f" {json.dumps(gates)}; {json.dumps(measured)}")
        if not all(gates.values()):
            raise AssertionError(f"(w): {[k for k, v in gates.items() if not v]} fail")

        encode_s = {}
        for h, w in ((1014, 898), (SIZE, SIZE)):
            px, runs = depth_writer_rgba(h, w), []
            for _ in range(3):
                t0 = time.perf_counter()
                n = len(avif_encode.encode_avif(px))
                runs.append(time.perf_counter() - t0)
            encode_s[f"{w}x{h}"] = min(runs)
            print(f"(w) encode_avif of a {w}x{h} depth map: {min(runs):.4f} s (best of 3,"
                  f" {[round(r, 4) for r in runs]}), {n} bytes ({os.cpu_count()} CPUs)")
        records["avif depth map"] = cli_record(
            "(w) AVIF depth map", run["seconds"], run["rec"].phases, run["decode"],
            run["launches"], smi, run["encode"],
            encode_s_avif={k: round(v, 4) for k, v in encode_s.items()},
            cli_psnr_db=round(psnr, 4), maps=measured)
        pil = any(m == "PIL" or m.startswith("PIL.") for m in sys.modules)
    print(f"(w) Pillow imported during the runs {pil}; (w) took"
          f" {time.perf_counter() - t_phase:.1f} s")
    if pil:
        raise AssertionError("(w): Pillow was imported")
    return records


def main() -> int:
    t_script = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port runs on the card",
              file=sys.stderr)
        return 1
    from cybervision_tpu_torch import kernels
    from cybervision_tpu_torch.ops import gather, ncc_sweep, score
    from cybervision_tpu_torch.utils.buckets import pow2_bucket

    device = torch.device("cuda")
    smi = nvidia_smi_line()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda};"
          f" fp32 matmul TF32 {torch.backends.cuda.matmul.allow_tf32}")
    print(f"Pillow installed on this machine: {importlib.util.find_spec('PIL') is not None}"
          " (the port reads its files without it)")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmul is on: first_pass needs full fp32")
    t0 = time.perf_counter()
    kernels.library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s")
    ptxas_report()

    t0 = time.perf_counter()
    sweep = phase_sweep(device)
    awkward = phase_sweep_awkward(device)
    img1, img2, disparity = synth_sem_pair(SIZE, SIZE)
    matches = main_path_matches(img1, img2, device)
    m_main = pow2_bucket(len(matches), floor=2048, factor=4)
    print(f"main path: {len(matches)} matches, RANSAC table M = {m_main}")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    sizes = sorted({8192, m_main})
    score_r = {m: check_score(matches, m, device, gen) for m in sizes}
    score_awkward = [
        check_score(matches, m_main, device, gen, c=BATCH + 1, mask=mask, reps=0)
        for mask in ("holes", "none")
    ]
    gather_r = {m: check_gather(matches, m, device, gen) for m in sizes}
    draws = check_draws(device)
    mesh = chip_mesh()
    wide = phase_sweep_wide(device, mesh)
    print(f"kernel checks took {time.perf_counter() - t0:.1f} s")

    counters = {"ncc_sweep": (ncc_sweep, "launches"),
                "score_candidates": (score, "launches"),
                "gather_packed": (gather, "launches")}
    e2e = phase_end_to_end(img1, img2, disparity, counters)
    print("RANSAC phase of the best run, threefry draws:"
          f" {e2e['phases']['Completed RANSAC fitting']} s")
    device_ms = profile_end_to_end(img1, img2)
    ransac_full = phase_ransac_all_rounds(
        matches, device, {k: counters[k] for k in ("score_candidates", "gather_packed")})

    t0 = time.perf_counter()
    print(f"mesh: {mesh.describe()} ("
          + ("every visible card" if len(set(mesh.devices)) > 1 else
             "row shards on one card: the only card visible") + ")")
    sharded = phase_mesh_sweep(mesh, sweep)
    e2e_mesh = phase_end_to_end(
        img1, img2, disparity,
        dict(counters, ncc_sweep_sharded=(ncc_sweep, "sharded_launches")),
        mesh=mesh, label="end to end under the mesh",
    )
    check_mesh_launches(e2e_mesh, mesh.size)
    check_sharded_plan("end to end under the mesh", e2e_mesh["plan"], img1.shape, img2.shape,
                       mesh)
    device_ms_mesh = profile_end_to_end(img1, img2, mesh, "profile under the mesh")
    phase_same_correlation(img1, img2, matches, mesh, device)
    print(f"multi-device phase took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    depth_map = phase_depth_map(img1, img2, disparity, e2e["xyz"], counters)
    texture_obj = phase_texture_obj(device, counters, gen)
    print(f"affine lanes phase took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    persp = phase_perspective(device, counters, gen)
    print(f"perspective phase took {time.perf_counter() - t0:.1f} s")
    b3, b5, full, diag = (persp["runs"][k] for k in ("baseline3", "baseline5", "full_width",
                                                     "diagonal"))

    t0 = time.perf_counter()
    persp_mesh = phase_mesh_perspective(mesh, device, counters, persp)
    print(f"perspective under the mesh phase took {time.perf_counter() - t0:.1f} s")
    b5_mesh, diag_mesh = persp_mesh["baseline5"], persp_mesh["diagonal"]

    t0 = time.perf_counter()
    cli_files = phase_cli_files(counters, smi, texture_obj["obj_sha256"])
    print(f"CLI from files phase took {time.perf_counter() - t0:.1f} s")

    def record(name, source, replaces, main, errs, run=e2e, dev_ms=device_ms,
               dev_name=None, large=None, at_persp=None):
        rec = {
            "name": name, "route": "cuda",
            "source": f"cybervision_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": run["launches"][name],
            "max_abs_err": max(errs),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main.get("library_ms"),
            # Device time of the wrapper's kernels in one profiled e2e run.
            "device_ms_per_run": dev_ms[dev_name or name],
        }
        if large is not None:
            # Phase 5: launches per run of BASELINE #1 and #4, and the
            # kernel at #4's shapes.
            rec.update({
                "launches_baseline1": depth_map["launches"][name],
                "launches_baseline4": texture_obj["launches"][name],
                "device_ms_per_run_baseline4": texture_obj["device_ms"][name],
                **{f"{k}_baseline4": large[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            })
        if at_persp is not None:
            # Phase 6: launches per run of BASELINE #3, #5, the
            # full-width 3-view run and the diagonal pair, device ms in
            # their profiled runs, and the kernel at the path's shapes.
            rec.update({
                "launches_baseline3": b3["launches"][name],
                "launches_baseline5": b5["launches"][name],
                "launches_full_width": full["launches"][name],
                "launches_diagonal": diag["launches"][name],
                "device_ms_per_run_full_width": full["device_ms"][name],
                "device_ms_per_run_diagonal": diag["device_ms"][name],
                **{f"{k}_perspective": at_persp[k]
                   for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            })
        return rec

    large = texture_obj["kernels"]
    kernels_line = {"kernels": [
        record("ncc_sweep", "ncc_sweep.cu",
               "cybervision_tpu/ops/pallas_ncc.py:93", sweep["horiz"],
               [r["err"] for r in [*sweep.values(), *awkward, *wide,
                                   large["K1 horiz"], large["K1 vert"], persp["k1_pixel"]]],
               large=large["K1 horiz"], at_persp=persp["k1_pixel"]),
        record("score_candidates", "score_candidates.cu",
               "cybervision_tpu/ops/pallas_score.py:56", score_r[m_main],
               [r["err"] for r in [*score_r.values(), *score_awkward, large["K2"],
                                   persp["k2"]]],
               large=large["K2"], at_persp=persp["k2"]),
        dict(record("gather_packed", "gather_packed.cu",
                    "cybervision_tpu/ops/pallas_gather.py:60", gather_r[m_main],
                    [r["err"] for r in [*gather_r.values(), large["K3"], persp["k3"]]],
                    large=large["K3"], at_persp=persp["k3"]),
             **{k: gather_r[m_main][k] for k in (
                 "device_us_per_call", "library_device_us_per_call",
                 "host_us_per_call", "library_host_us_per_call")}),
        record("ncc_sweep_sharded", "ncc_sweep.cu",
               "cybervision_tpu/ops/pallas_ncc.py:682", sharded["horiz"],
               [r["err"] for r in sharded.values()], run=e2e_mesh,
               dev_ms=device_ms_mesh, dev_name="ncc_sweep"),
    ]}
    kernels_line["kernels"][0].update({
        f"launches_{key}_per_pixel": r["launches"]["ncc_sweep_pixel"]
        for key, r in persp["runs"].items()
    })
    kernels_line["kernels"][0].update({
        f"device_ms_per_run_{key}_per_pixel": r["device_ms"]["ncc_sweep_pixel"]
        for key, r in (("full_width", full), ("diagonal", diag))
    })
    # Phase 7: K1s's per-pixel form on the diagonal pair under the mesh
    # (K1 launches per run, all per-pixel, and the sharded sweeps), its
    # device ms in the profiled run; K2/K3 and P3P's blocks per run there
    # and in BASELINE #5 under the mesh.
    for key, r in (("baseline5", b5_mesh), ("diagonal", diag_mesh)):
        kernels_line["kernels"][3].update({
            f"launches_mesh_{key}_per_pixel": r["launches"]["ncc_sweep_pixel"],
            f"sharded_calls_mesh_{key}": r["launches"]["ncc_sweep_sharded"],
            f"device_ms_per_run_mesh_{key}_per_pixel": r["device_ms"]["ncc_sweep_pixel"],
        })
        for rec in kernels_line["kernels"][1:3]:
            rec[f"launches_mesh_{key}"] = r["launches"][rec["name"]]
        kernels_line["kernels"][3][f"p3p_blocks_mesh_{key}"] = r["launches"]["p3p_score"]
    # Phase 8: launches per run of the CLI from files.
    for rec in kernels_line["kernels"][:3]:
        for key, r in cli_files.items():
            rec[f"launches_cli_{key.replace(' ', '_').replace('-', '_')}"] = r["launches"][rec["name"]]
    # The per-pixel form at 1024x1024 (phase 2's checkerboard of axes),
    # for K1 and over the mesh for K1s; "*_perspective" above is K1's
    # per-pixel form on the diagonal run's finest fields.
    for rec, r in ((kernels_line["kernels"][0], sweep["per-pixel"]),
                   (kernels_line["kernels"][3], sharded["per-pixel"])):
        rec.update({f"per_pixel_{k}": r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")})
    print(f"end-to-end seconds (warm, best of 3): {e2e['seconds']:.4f} on one"
          f" card, {e2e_mesh['seconds']:.4f} over {mesh.describe()}; RANSAC"
          f" of all 20 rounds {ransac_full['seconds']:.4f} s; one round's draws"
          f" {draws['ms']:.4f} ms (torch.randint {draws['torch_randint_ms']:.4f} ms);"
          f" BASELINE #1 (PNG depth map) {depth_map['seconds']:.4f} s, best of 3;"
          f" BASELINE #4 (4032x3024 texture OBJ) {texture_obj['seconds']:.4f} s, best of 2;"
          f" BASELINE #3 (perspective pair -> OBJ) {b3['seconds']:.4f} s, best of 2;"
          f" BASELINE #5 (3-view SFM -> PLY) {b5['seconds']:.4f} s, one run;"
          f" 3 views at 1024x820 {full['seconds']:.4f} s, one run;"
          f" diagonal pair at 1024x820 {diag['seconds']:.4f} s, one run;"
          f" over {mesh.describe()}: BASELINE #5 {b5_mesh['seconds']:.4f} s and the diagonal"
          f" pair {diag_mesh['seconds']:.4f} s, one run each; the CLI from the SEM TIFFs"
          f" {cli_files['cold']['seconds']:.4f} s cold, {cli_files['warm process']['seconds']:.4f} s"
          f" in a warm process, {cli_files['in-process']['seconds']:.4f} s in process (best of 3);"
          f" to a JPEG depth map {cli_files['jpeg depth map']['seconds']:.4f} s; the progressive"
          f" pair {cli_files['progressive jpeg']['seconds']:.4f} s; tiled, planar and BigTIFF"
          f" {[round(cli_files[f'tiff {k}']['seconds'], 4) for k in ('tiled', 'planar', 'bigtiff')]} s;"
          f" gray-palette BMPs {cli_files['bmp ply']['seconds']:.4f} s; float TIFF, JPEG-in-TIFF"
          f" and RLE8 BMP depth maps"
          f" {[round(cli_files[k]['seconds'], 4) for k in ('float tiff', 'jpeg tiff', 'rle8 bmp')]} s;"
          f" 16-bit PGM, SPIDER, RLE TGA and CMYK TIFF pairs"
          f" {[round(cli_files[k]['seconds'], 4) for k in ('pgm ply', 'spider png', 'tga obj', 'cmyk tiff ply')]} s;"
          f" LZMA TIFF, DIB, zstd TIFF and text-EXIF PNG pairs"
          f" {[round(cli_files[k]['seconds'], 4) for k in ('lzma tiff ply', 'dib png', 'zstd tiff obj', 'text exif png obj')]} s;"
          f" Sun raster and IM pairs"
          f" {[round(cli_files[k]['seconds'], 4) for k in ('sun ply', 'im obj')]} s;"
          f" arithmetic, arithmetic progressive and lossless JPEG pairs"
          f" {[round(cli_files[k]['seconds'], 4) for k in ('arith ply', 'arith progressive obj', 'lossless ply')]} s;"
          f" DXT1 DDS, BC7 DDS and BLP2 DXT5 pairs"
          f" {[round(cli_files[k]['seconds'], 4) for k in ('bc1 dds ply', 'bc7 dds png', 'blp dxt5 obj')]} s;"
          f" FLC, Photo CD and rotated Photo CD pairs, QOI and PPM depth maps"
          f" {[round(cli_files[k]['seconds'], 4) for k in ('flc ply', 'pcd png', 'pcd rotated png', 'qoi depth map', 'ppm depth map')]} s;"
          f" 9/7 JP2, 9/7 and 5/3 codestream pairs"
          f" {[round(cli_files[k]['seconds'], 4) for k in ('jp2 97 obj', 'j2k 97 ply', 'j2k 53 obj')]} s;"
          f" GIF depth map {cli_files['gif depth map']['seconds']:.4f} s")
    print(f"chip_smoke.py took {time.perf_counter() - t_script:.1f} s")
    print(smi)
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
