#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (pfb_tpu_torch) runs its
imaging paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases:
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: compile the hand-written kernels from pfb_tpu_torch/csrc (one
     nvcc per source, in parallel), and say which host plan builder runs;
  3. wgrid path: simulate a 64-antenna, 128-integration, 8-channel
     observation (2.06 M visibilities, random point sources from a fixed
     seed), then init -> grid(backend="wgrid", 2048^2, PSF 4096^2) ->
     spotless(engine="pallas", backend="wgrid", 3 major iterations), with
     every kernel's launch count reset just before and read just after;
  4. kernel vs plain for that path: the PSF-convolution kernel (K1) with
     the transfer function of the grid phase's PSF, complex and its real
     even part; the c2c transform (fftx_c2c) on the image and PSF w-plane
     stacks and on the blocked residual's forward block (4, 4096^2 ->
     8192^2), each 2-D transform, its x pass alone on the cluster column
     kernel (K3c, fftx_c2c_cluster) and its y pass alone on the row
     kernel (K3r, fftx_c2c_rows), with K3r also at the K11 path's
     lengths (8, 6144^2) and (2, 12288^2); the line kernel (K3,
     line_fft_kernel) on the x pass of (9, 1350^2), inverse, a length
     its route still takes (N % 4 == 2; no 128-aligned imaging path runs
     it since the routes reach 256);
  5. checks of the wgrid path: launches > 0 inside grid and spotless
     (K1, K3r on its y passes and K3c on its x passes),
     kernel errors within tolerance, the MFS residual rms after the last
     major iteration below the dirty rms, the brightest simulated sources
     recovered at their pixels;
  6. pg path, same observation: init -> grid(backend="pg", robustness=0,
     2048^2, PSF 4096^2) -> spotless(engine="pallas", backend="pg", 3 major
     iterations), counts reset just before and read just after; the plans'
     w planes and tiles;
  7. kernel vs plain for the pg gridder: spread (K4) and fold (K5) on one
     dataset's image plan and PSF plan, degrid (K6) on the image plan with
     the w-plane grids of the pg path's model; and the pg dirty image
     against the wgrid dirty image of the same dataset and weights
     (max|diff| <= 1e-4 max|wgrid|); K4's parts on each plan (the slots'
     chains, the skeletons' split and the longest slot alone,
     spread_parts); K6's parts on the image plan (the skeletons of its
     window design and of the earlier thread design, degrid_parts);
  8. checks of the pg path, as in 5, with K3c, K3r, K4 and K5 launched
     in grid and spotless and K6 in spotless;
  9. klean path, same observation, reusing the pg path's xds and copies
     of its dds: klean(backend="pg", plane_block=4, epsilon=1e-5, 3 major
     iterations, sub_peak_factor 0.9, see KLEAN), counts reset just
     before and read just after; K7-K9, K3c and K3r
     must launch inside klean and K4-K6 must not (its residual takes the
     w-plane-blocked engine), the MFS residual rms must end below the
     dirty rms and the brightest sources must sit at their pixels;
 10. blocked against unblocked on one pg dataset at 2048^2: the
     plane_block=4 residual operator against the all-planes one on the
     pg path's model (max|diff| <= 1e-5 max), and the blocked spread (K7)
     and fold (K8) on the block with the most entries, the blocked degrid
     (K9) on that block with its model grids, against their plain
     versions, with K7's and K9's parts on that block as in 7;
 11. the blocked engine at its own scale, the flagship operator of
     bench.py: 1,000,000 rows x 8 channels from default_rng(0), 4096^2,
     epsilon 1e-5, plane_block 4 (nw 20, 5 blocks, 8192^2 grids): host
     plan seconds, adjoint and Hessian seconds (median of 3 after a
     warm-up) and Mvis/s, peak device memory, for plane_block=4 and for
     all planes at once, counts reset just before each and read just
     after (K3c, K3r and K7-K9 must launch in the blocked one); blocked
     against unblocked (<= 1e-5 max); K7-K9 against plain on the largest
     block, with K7's and K9's parts there as in 7;
 12. K11 path: the same observation re-simulated at 3072^2 with the cell
     at 2/3 of the 2048^2 paths' (same 0.93 deg field, same w planes),
     then init -> grid(backend="pg", robustness=0, 3072^2, PSF 6144^2) ->
     spotless(engine="pallas", backend="pg", 3 major iterations): NX =
     6144 fails v3's factor rule, so spotless takes the general PSF
     kernel (K11) with the host power method and primal_dual_hostloop;
     K11 must launch inside spotless and K1 and K2 must not, K3c and K3r
     inside grid and spotless; residual and sources checked as in 5;
 13. K11 against plain: at (8, 3072^2) in 6144^2 with the phase-12 PSF's
     full transfer function, and at psf_oversize 1.5 (3072^2 in 4608^2)
     with a random non-Hermitian H;
 14. K2 path: with the pg path's 2048^2 PSF cube, per-band wsum shares
     and sigmainv 1e-2, the CG-fused solver (make_pcg_bands_fused with
     apply_cg, on K2) against pcg_bands(tol=0) on K1 for 25 iterations
     (<= 1e-4 of max), K2 against plain there; then bench.py's PCG case
     (4096^2 x 8, delta PSF 0.5 at the centre, real_transfer=False, 50
     iterations, no backtracking): K2 and K1 against plain, and PCG it/s
     of the CG-fused solver, of pcg_bands on K1 and of
     pcg_bands_hostloop on K1, counts reset just before and read just
     after. K2 takes K1's column route (the cluster kernels K10ac /
     K10cc at both sizes, whose counters count K2's launches: K10ac =
     K10cc = K1 + K2 over the solves); printed for each K2 case: its
     routes, its conv bitwise K1 of its own p, its reruns bitwise, and
     at bench.py's case the time of each stage alone (psf_cg_stages);
 15. K10 against plain at the dist path's shapes (a (2, 4) mesh: 4-band
     rows, 512 columns or 513 of the 2052 padded spectrum rows per shard)
     with the grid phase's PSF, per stage;
 16. the space-sharded matvec (hessian_psf_space_dist(method="pallas"),
     K10 with all-to-all transposes, on a (2, 4) virtual mesh of the card)
     against K1 on the whole (8, 2048^2) cube (<= 1e-6 of max; whether
     they are bitwise equal, and both times);
 17. dist path: _spotless_dist(engine="pallas", backend="pg", 3 major
     iterations) on a (2, 4) virtual mesh with the pg path's datasets
     (init and grid reused) and hessnorm, counts reset just before and
     read just after: K1 on the band-local data step, K10 in every
     primal-dual gradient with the halo-exchange Psi, K4-K6 in the exact
     residual, K11 and K2 never; its model against the pg path's
     _spotless model (<= 1e-3 of max), residual and sources as in 5;
 18. make_vis2dirty_rowdist on a (1, 4) virtual mesh (K4, K5 per row
     shard, one sum of the grids) against the pg path's one-device dirty
     image of dataset 0 (<= 1e-5 of max);
 19. make_hessian_dds_dist(plane_block=4) (K7-K9) against all planes
     (K4-K6) on a (2, 1) virtual mesh, the pg path's model (<= 1e-5 of
     max);
 20. the single-band entry points of ops/pallas_fft.py at one band of
     4096^2 in 8192^2, counts reset just before and read just after they
     run: K12 (psf_convolve_pallas_v3) on band 0 of phase 14's bench PSF
     with complex and real H and on a random PSF from a fixed seed, K13
     (psf_convolve_pallas_v2) and K14 (psf_convolve_pallas_opt) on the
     full complex H of both; each against its plain version, and K12,
     K13 and K14 against each other on each PSF (<= 1e-5 of max);
 21. K15, the v3 column transforms (v3_cols_fwd, v3_cols_inv) at (8,
     4096^2), NX = 8192, NXH = 4224: forward then inverse, counts reset
     just before and read just after, the round trip against x (<= 1e-5
     of max); each against its plain version, the inverse also on a
     random non-Hermitian spectrum, with the library column calls;
 22. L2, the x-pass lab's kernels (scripts/torch_g2i_lab.py) at (4,
     8192^2) and its x pass of (9, 2048^2) through fftx_c2c (the cluster
     kernel K3c since the route reaches 2048), and the line kernel K3
     (which no imaging path here launches) on the y pass of (9, 3000^2),
     counts reset just before and read just after they run: the
     copy probes (L2a, ops/memlab.py: strip, rows, relayout, batched, and
     the strip skeleton of re and im), the split-precision x pass (L2b,
     fftx_c2c_split) and the line kernel with lab launch parameters (L2c,
     fftx_c2c_lab: S = 2, and the first radix pass alone, the x pass
     before the cluster kernel); then each against its plain version:
     copies exact, L2c and the split pass <= 1e-5 of max (the split
     pass's error against a float64 transform is printed, not gated);
 23. L3, the capacity lab (scripts/torch_capacity_lab.py) on the TPU
     lab's observation (125,000 rows x 8 channels, 1024^2, epsilon 1e-5),
     counts reset just before and read just after: _spread_fold (K4 + K5)
     at capacity 128, 256 and 512, whose grids must agree (<= 1e-5 of
     max), and K4 through pack_entries at pair width 1 and 2; the paired
     spreads against the plain spread (<= 1e-5 of max) and the sweep's
     times;
 24. the PSF column stages' cluster kernels (csrc/psf_cols.cu: K10ac,
     psf_cols_fwd, and K10cc, psf_cols_inv), which every PSF entry with
     a column stage launches at NX >= 2048, at the shapes the paths give
     them: K1 on the main paths (8, 2048 -> 4096, 2048), K1 and K12 at
     (8, 4096 -> 8192, 4096), one shard of the dist path's K10 (4, 2048,
     512) -> 2052 rows and back, K11 (8, 3072 -> 6144, 3072), K15's NXH
     = 4224 rows at 8192 (its inverse on a random non-Hermitian
     spectrum), K1 and K2 at 1024^2 (NX = 2048), K11 at 1280^2 in
     2560^2 and 1536^2 in 3072^2; each against the functions' plain
     versions (rfft / irfft). Both must have launched inside the wgrid
     and pg _spotless (K1), _spotless_dist (K10), the 3072^2 _spotless
     (K11) and the 1024^2 _spotless (K1), and the PSF column stages'
     line kernels inside none of them;
 25. the PSF rows stage's register kernel (csrc/psf_rows.cu: K10br,
     psf_rows), which every PSF entry's rows stage launches at NY = 2048,
     2560, 3072, 4096, 4608, 5120, 6144, 8192 and 12288, at the shapes
     the paths give it: K1 on the main paths (8, 2049 rows, 2048) of 4096
     with complex and real H, K1, K2 and K12 (8, 4097, 4096) of 8192, one
     shard of the dist path's K10 (4, 513, 2048), K11 (8, 3073, 3072) of
     6144 and K13 / K14 (1, 4097, 4096) of 8192 with the full H, K1 and
     K2 (8, 1025, 1024) of 2048, K11 with the full H at (8, 1281, 1280)
     of 2560, (8, 1537, 1536) of 3072, (2, 2305, 3072) of 4608 (phase
     13's psf_oversize 1.5) and (2, 2561, 2560) of 5120; each against
     the plain stage
     (psf_stage_rows_plain), with the stage as three torch.fft calls
     printed beside it for context; then the L1 lab's rows stage on K15's
     NXH = 4224 rows (psf_stage_rows at (8, 4224, 4096) of 8192), counts
     reset just before and read just after. K10br must have launched
     inside the wgrid and pg _spotless (K1), _spotless_dist (K1, K10), the
     3072^2 _spotless (K11), the PCG phase (K1, K2), the single-band phase
     (K12-K14), L1's run and the 1024^2 _spotless (K1), once for each rows
     stage those entries ran, and psf_rows_kernel, the shared-memory line
     kernel, never;
 26. the 1024^2 pg path: the observation of phase 3 re-simulated at
     1024^2 (the same cell, half the field), init -> grid(backend="pg",
     robustness=0, 1024^2, PSF 2048^2) -> spotless(engine="pallas",
     backend="pg", 3 major iterations), counts reset just before and read
     just after: the image grids' 2048^2 transforms and the PSF's K1 at
     NX = NY = 2048 take the cluster column kernels (K3c, K10ac, K10cc)
     and the register row kernels (K3r, K10br), and neither
     line_fft_kernel (K3) nor the PSF stages' line kernels launch inside
     grid or spotless; residual and sources checked as in 5. Then K1
     against plain with this path's PSF, K3c and K3r at (9, 2048^2), (10,
     2560^2) and (9, 3072^2) in both directions, and the CG-fused solver
     (K2 at NX = 2048, on the cluster column kernels) against pcg_bands
     on K1 with this path's PSF cube (<= 1e-4 of max), K2 against plain
     there;
 27. the post-deconvolution path, run after phase 9 on its products
     (phase 3's observation, the pg path's xds and dds, the klean path's
     dds, model and residual; nothing cut), each step's counts reset just
     before it and read just after, with its seconds and peak device
     memory: model2comps(Legendre, nbasisf 8), whose mds must reproduce
     klean's model at the fit points to 1e-7 relative (1 + model, the
     gate of tests/test_models_io.py:108); degrid(backend="pg", epsilon
     1e-5, a plan per band) into MODEL_DATA, launching K6 once per band,
     K3c and K3r, and K3 never, with its host planning, degrid and
     update_ms_column seconds; init(DATA-MODEL_DATA) -> grid(pg, 2048^2,
     no PSF), whose MFS dirty image must equal klean's MFS residual
     within 1e-4 of the pg path's MFS dirty peak (XTOL: klean's residual
     rms is near float32 rounding, so a gate relative to the residual's
     own peak would test rounding); grid(transfer_model_from=the mds),
     whose MFS residual must meet the same gate, launching K4, K5 and K6;
     restore(outputs "mMrRiIc") of the klean dds, whose FITS files must
     exist, with a finite image_mfs holding the three brightest true
     sources at their pixels; fluxmop(backend="pg", use_psf, sigmainv
     1e-4, gamma 0.9, cg_maxit 100) from the pg path's dirty image, whose
     MFS residual peak must fall below 0.6 of the MFS dirty peak (the
     gate of tests/test_aux_workers.py:38) with K4, K5 and K6 launched in
     its exact residual, and the same step on a (1, 4) virtual space mesh
     (distributed rFFT2 Hessian), whose model must match within 1e-4 of
     max (CTOL) with no K10 stage launched, whose Hessian must be the
     mesh's (fluxmop's stats["hessian"] "psf space mesh (1, 4)": not
     the single-program fallback);
 28. fwdbwd, fastim and smoovie after phase 27, on phase 3's observation
     and the pg path's products at full width, each step's counts,
     seconds and peak device memory as in 27: fwdbwd(backend="pg",
     parametrisation "id", rmsfactor 0.3, bases "self,db1", nlevels 2,
     niter 3; the settings of tests/test_fwdbwd.py:45-47) on copies of
     the pg path's dds without MODEL, written to a dds store, whose MFS
     residual peak must fall below 0.5 of the MFS dirty peak
     (tests/test_fwdbwd.py:49-51) with PARAM written, K3c, K3r, K4, K5
     and K6 launched and no PSF kernel (K1, K2, K11, K10ac, K10cc,
     K10br: its PSF Hessian is torch.fft, as the JAX package's is XLA's
     FFT); fastim(backend="pg", epsilon 1e-5, 2048^2 at the pg path's
     cell, natural weights, one band, 4 integrations a snapshot: 32
     snapshots of 8064 rows x 8 channels) with no model and with phase
     27's mds degridded two channels a sub-band, each against one fastim
     call of all 128 integrations: the snapshots' RESIDUAL sum within
     1e-5 of the model-free one image's peak (SNAPTOL, the gridder's
     epsilon on the scale of the sky: the model run's residual is near
     float32 rounding of the model visibilities, which the 32 small
     plans and the one large plan degrid to epsilon each; the reading
     against the run's own peak is printed) and their WSUM sum within
     1e-6 relative (gridding is linear); the
     pg path's cell goes in arcsec and the mds takes the cell it
     converts back to (an ulp away at most), so the model renders on
     fastim's grid without a regrid; K4 and K5 at least once a snapshot,
     K6 at least 4 a snapshot with the mds and never without, K3 never;
     snapshots a second printed; the first snapshot's vis2dirty (K4,
     K5, K3c, K3r) and its first model sub-band's dirty2vis (K6, K3c,
     K3r), each on that snapshot's own pg plan, against the same calls
     with the plain versions in the kernels' place (plain_gridder, which
     must launch nothing), at the kernel tolerance; smoovie(animate_axis
     "time", time_bin 2, gif) on the model-free snapshots: 16 finite
     frames and the movie file;
 29. the CLI path at full width, after phase 28, in this process:
     ``cli.main(["--device", "cuda", "pipeline", <recipe>],
     standalone_mode=False)`` with the recipe of phase 6's init -> grid
     -> spotless (cli_recipe: phase 3's observation, every parameter whose
     schema default differs from what phase 6 passes stated), counts reset
     before the recipe and read at each step's start (the pipeline's
     "step i/n" log line) and after it: the model and MFS residual read
     back from the written dds store against phase 6's within 1e-5 of the
     MFS dirty peak (the maximum difference and whether they are equal bit
     for bit printed), each stage's launches of K1, K3c, K3r and K4-K6
     equal to phase 6's and K3 at 0; then the recipe's grid step as a grid
     command of its own under ``--profile-dir`` (a trace of the whole
     recipe is too large to keep), with the same launches, whose
     torch.profiler trace must name at least one of the port's kernels
     (its size and export seconds printed);
 30. two processes on the card: two ``python3`` subprocesses join through
     ``set_client(coordinator="127.0.0.1:<free port>", num_processes=2,
     process_id=r, devices=["cuda:0"])`` (gloo, host-staged) and read
     phase 29's dds store (the (8, 4096^2) PSF, phase 29's model as x);
     each runs hessian_psf_dist(engine="pallas") and power_method_dist on
     a (2, 1) band mesh (4 bands a process) and
     hessian_psf_space_dist(method="pallas") on a (1, 2) space mesh (K10
     with all-to-alls across the processes), and writes its gathered
     results, launches and seconds to an npz; this process runs the same
     on one-process meshes of the same shapes on the card. The matvecs
     within 1e-6 of max (STOL) and beta within 1e-6 relative (whether each
     is equal bit for bit printed), K1 and the K10 stages launched in each
     process, both processes ending with 0 within their timeout;
 31. backend "mm" after phase 30 (the JAX package's matmul gridder, which
     the port runs on the pg gridder): grid(backend="mm", robustness 0,
     2048^2, PSF 4096^2) on phase 6's xds, its DIRTY and PSF within 1e-6
     of max (STOL) of phase 6's pg products (whether equal bit for bit
     printed), K4, K5, K3c and K3r launched and K3 not; then the joint
     solve (make_hess_vis_dct(backend="mm") on band 0's dataset with two
     1024^2 fields 60 field widths apart, without the w term, which would
     need thousands of w planes there): self-adjoint within 1e-4, cg_dct's
     residual after 20 iterations below b's, K4, K5, K6, K3c and K3r
     launched and K3 not; each step's seconds and peak memory printed.
 32. after phase 26: (a) the 1920^2 pg path, phase 3's observation
     re-simulated at 1920^2 with the 2048^2 paths' cell, init ->
     grid(backend="pg", robustness=0, 1920^2, PSF 3840^2) ->
     spotless(engine="pallas", backend="pg", 3 majors), counts reset
     just before and read just after each stage, seconds and peak memory
     by stage: v3 does not hold at 1920^2, so spotless runs K11 (K1 and K2
     never); its image grids' y passes are at 3840 (R2 = 15), its PSF
     grids' at 7680 (R2 = 30) and K11's rows stage at 3840, all on the
     register row kernels: K3c, K3r, K4 and K5 inside grid and spotless,
     K6, K10ac, K10cc, K10br (once each rows stage) and K11 inside
     spotless, and neither line_fft_kernel (K3) nor psf_rows_kernel nor
     the PSF column line kernels inside either; residual and sources as
     in 5. (b) Records: K3r's y pass at every length whose R2 is 9, 15,
     25, 27, 30, 36, 40, 45, 50, 54, 60 or 64 (2304-16384; 9 planes up
     to 8192, 2 above), inverse out_rolled and forward in_rolled; K10br
     at each of those NY on (8, NY/2 + 1, NY/2) rows with a complex H
     (K1's), and the full H at 3840 (K11's of (a)); the four-step (K3f,
     then K3c at N / 8, the lab's route at these lengths since K3xl and
     K3yl) at N = 18432 and 32768 (the PSF grids of 4608^2 and 8192^2
     images) on one plane, its x pass and the y pass of the rows that
     leaves, inverse out_rolled: K3f alone (its bound its own bytes), and
     the route (K3f once, then K3c once); the long column kernel (K3xl)
     on the x pass and the long row kernel (K3yl) on the rows there,
     inverse out_rolled ((1, N, N), N/2 rows of N) and forward in_rolled
     ((1, N/2, N/2), N rows of N/2), each with the four-step's time on
     the same inputs (``old_ms``), and beside each the lab's one-pass
     design of the same pass (K3cl, K3fr); each against its plain version
     (the plain rows stage, the plain versions in chunks of bands,
     columns or rows, the whole stack at once needing several times its
     size). (c) grid(backend="pg") at 4608^2 on a small observation (8
     antennas, 4 integrations, 2 channels; w-gridding off, so that one
     plane of its 18432^2 PSF grid fits), counts reset just before and
     read just after: K3xl and K3yl once a dataset (the PSF grid's x and
     y passes), K3f and K3 never, its PSF and dirty image within 1e-5 of
     their peaks of the same call on the kernels' plain versions.
 33. after phase 32: (a) the 512^2 pg path, phase 3's observation
     re-simulated at 512^2 with the same cell (a quarter of the 1024^2
     field; 64 antennas, 128 integrations, 8 channels, nothing cut), init
     -> grid(backend="pg", robustness=0, 512^2, PSF 1024^2) ->
     spotless(engine="pallas", backend="pg", 3 majors), counts reset
     just before and read just after each stage, seconds and peak memory
     by stage: its image grids (1024^2), PSF grids (2048^2) and PSF
     Hessian (NX = NY = 1024) on the short designs (the cluster column
     kernels on one block or clusters of two, the register row kernels several
     rows a block): K3c, K3r, K4 and K5 inside grid and spotless; K1, K6,
     K10ac, K10cc and K10br (once each rows stage) inside spotless, K11
     never; neither line_fft_kernel (K3), the PSF column line kernels nor
     psf_rows_kernel inside either; residual and sources as in 5; K2's
     CG-fused PCG against pcg_bands on K1 with this path's PSF cube (<=
     1e-4 of max), its columns on the cluster route, its rows on K10br,
     its conv K1's of its own p and its reruns bit for bit, as phase 26
     checks at 1024^2. (b) The same at 768^2 (PSF 1536^2: R2 = 6 and a
     factor 3 on both designs; its PSF grids of 3072^2 on the routes of
     phase 26), where v3 does not hold (NX = 1536 = 48 x 32: 32 does not
     divide 48), so spotless runs K11 with primal_dual_hostloop on the
     same column and rows kernels, as phase 32 at 1920^2: K11 instead of
     K1 inside spotless, K1 and K2 never, and no K2 check. (c) Records: at every short length N = 256-1536, K3c's x
     pass and K3r's y pass of (9, N^2), inverse out_rolled and forward
     in_rolled, K10ac / K10cc at (8, N/2, N/2) of N and K10br on (8, N/2
     + 1, N/2) rows of N with a complex H, each against its plain version
     (<= 1e-5 of max) with its time, bound, library time and the time of
     the line kernel these lengths took before (``line_ms``: the same
     inputs through fftx_c2c_lab, or ops/psf.py:psf_line_lab, which run
     line_fft_kernel and psf_rows_kernel whatever the routes say).
 34. after phase 33: the grid worker's w-gridded PSF at 4608^2. Phase 3's
     observation (64 antennas, 128 integrations, 8 channels, 4000 m, 20
     sources, seed 7, 2,064,384 visibilities) re-simulated at 4608^2 with
     its hour-angle span cut from 1 h to 7.5 min (SIM_W: over the hour a
     band's PSF grid needs more w planes of 18432^2 than the card holds;
     the cell made from its uv coverage), the planes a band and their
     bytes printed for both spans, then init -> grid(backend="pg",
     robustness=0, psf=True, do_wgridding=True, 4608^2, PSF 9216^2 on a
     18432^2 grid), counts reset just before and read just after: K3xl
     and K3yl (every PSF w plane's x pass and rows, four planes a call),
     K4 and K5 launched, K3f and K3 never; the grid's seconds and peak
     memory; the same call on the route K3xl and K3yl replaced (K3f twice
     as often as K3xl, its peak and seconds: the memory the full-size
     intermediate took) and on the kernels' plain versions (one plane a
     transform), the PSF and dirty image within 1e-5 of their peaks of
     both.
 35. after phase 34: the JAX package's last public functions, on phase
     6's data (no new simulation, no kernel): ops/weighting.py's device
     compute_counts on the card, k = 6 and k = 0, on every dataset of the
     pg path (2,064,384 visibilities, float64 uvw, its 2048^2 grid and
     cell) against compute_counts_host, the native builder the workers
     run, within 1e-9 of max, and counts_to_weights(robust=0) of both
     within 1e-9, with the seconds of both and the card's peak memory;
     ops/psf.py's hessian_psf_slice on each band of phase 6's (8,
     4096^2) PSF against hessian_psf_cube's band (1e-5 of max);
     make_psfhat(band_chunk=2) against the whole cube (1e-6 of max), with
     the peak memory of both; ops/prox.py's dual_update_21 in float32 on
     the card against float64 on the CPU, on coefficients of the pg
     path's SARA transform's shape (1e-6 of max). Its seconds printed.
Kernel tolerance: max|kernel - plain| <= 1e-5 max|plain|, with
CUDA-event medians of both. Every kernel record also carries the least
time the card could take for the same work (``bound_ms``: the larger of
the bytes the function must move over 3.35 TB/s and its FP32 operations
over 67 TFLOP/s, or its bf16 tensor-core operations over 989 TFLOP/s for
the split pass, counted for this run's inputs; ``bound_by`` says which)
and the time of one PyTorch call that computes the same function where
there is one (``library_ms``: torch.fft for K3, K3c, K3r and the
four-step route, the
column stages of K10 and K15, their cluster kernels K10ac and K10cc and
the x-pass labs L2b and L2c, a zero
fill and ``index_add_`` for the folds, a slice's ``clone`` for the copy
probes L2a; None otherwise: no
single call computes K1's, K2's, K10's rows stage's (K10br's, L1's),
K11-K14's padded convolution or L3's paired spread). A kernel's entry in
the kernels
line takes its times from its first record: K3's from the line
kernel's x pass at 1350, K3c's from its x pass, K3r's from its y pass,
K3f's from K3f alone on the four-step's x pass at 18432 (the route's
time, K3f and K3c at 2304, is a record of its own), K3xl's and K3yl's
from their inverse out_rolled passes at 18432, the lab's K3cl and K3fr
from theirs beside them. Each counts the
launches of its own kernel, so K3 + K3c + K3r is the number of launches
of the routes of ``fftx_c2c``, whose four-step launches K3f and K3c once
each; K10ac and K10cc
count the cluster column kernels' launches from every entry that runs a
PSF column stage on their route (K1, K2, K10, K11-K15), and K10br the
register rows kernel's from every entry that runs a rows stage on its
route (K1, K2, K10, K11-K14), whose own counters count their calls.

Exits non-zero (and prints no result line) when there is no CUDA device,
when the package is not beside this script, or when any phase fails.
The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

TOL = 1e-5
XTOL = 1e-4  # pg against wgrid dirty image
BTOL = 1e-5  # blocked against unblocked residual operator
HBM_BPS = 3.35e12  # H100 SXM memory rate (NVIDIA data sheet)
FP32_FLOPS = 67e12  # H100 SXM FP32 rate outside the tensor cores
BF16_TC_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate (data sheet)
NX = 2048
INIT = dict(precision="single", channels_per_image=1)
SIM = dict(nant=64, ntime=128, nchan=8, nsource=20, extent=4000.0,
           seed=7, gains=False)
GRID = dict(backend="wgrid", nx=NX, ny=NX, epsilon=1e-5, robustness=None,
            psf=True, residual=False)
SPOT = dict(engine="pallas", backend="wgrid", epsilon=1e-5,
            bases="self,db1,db2", nlevels=3, niter=3, pd_maxit=100)
GRID_PG = dict(GRID, backend="pg", robustness=0.0)
SPOT_PG = dict(SPOT, backend="pg")
# sub_peak_factor 0.9, not the default 0.5: the Clark subminor of both
# packages adds gamma xhat / w_b to the model but subtracts gamma xhat
# PSF_b, whose peak is w_b (about 1 / nband), so it overshoots unless
# nband ln(1 / sub_peak_factor) < 1; with 8 bands and 0.5 it diverges
KLEAN = dict(backend="pg", plane_block=4, epsilon=1e-5, niter=3,
             sub_peak_factor=0.9)
FLAGSHIP = dict(nx=4096, nrow=1_000_000, nchan=8, seed=0, epsilon=1e-5,
                plane_block=4)
NX_K11 = 3072  # NX = 6144 = 96 x 64: outside v3, the general PSF kernel
# cells of 1 / (2 srf uv_max f_max / c) with srf 3: 2/3 of the 2048^2
# paths' (srf 2), the same field of view
GRID_K11 = dict(GRID_PG, nx=NX_K11, ny=NX_K11, super_resolution_factor=3.0)
CTOL = 1e-4  # CG-fused solve against pcg_bands on K1
PCG = dict(nx=4096, nband=8, niter=50)  # bench.py's PCG case
NSPACE = 4  # virtual space shards of the dist path: a (2, 4) mesh
STOL = 1e-6  # space-sharded matvec against K1
DTOL = 1e-3  # dist model against the one-device model (JAX package's gate)
# the quick-look path: 1024^2, PSF 2048^2, pg grids 2048^2 and 4096^2
NX_SMALL = 1024
GRID_SMALL = dict(GRID_PG, nx=NX_SMALL, ny=NX_SMALL)
# (planes, N) of phase 26's pass records: the lengths below 4096
SMALL_PASSES = ((9, 2048), (10, 2560), (9, 3072))
# phase 32: the 1920^2 pg path (no v3: K11; rows at R2 = 15 and 30), the
# register row kernels' lengths whose R2 (9-64) they took last, and the
# four-step's lengths (the PSF grids of 4608^2 and 8192^2)
NX_1920 = 1920
GRID_1920 = dict(GRID_PG, nx=NX_1920, ny=NX_1920)
NEW_ROW_LENGTHS = (2304, 3840, 6400, 6912, 7680, 9216, 10240, 11520, 12800,
                   13824, 15360, 16384)
FOUR_LENGTHS = (18432, 32768)
# phase 33: the 512^2 and 768^2 pg paths on the short designs, and the
# short lengths (the grids and PSF Hessians of the 128-aligned images from
# 128^2 to 768^2) of its records
NX_SHORT = (512, 768)
SHORT_LENGTHS = (256, 512, 768, 1024, 1280, 1536)
# phase 34: the grid worker's w-gridded PSF at 4608^2 (a 18432^2 grid, both
# passes on K3xl and K3yl): phase 3's observation with the hour-angle span
# cut from 1 h to 7.5 min, so that a band's w planes fit the card (phase 34
# prints them for both spans); antennas, integrations, channels, bands and
# image width as phase 3's, the cell made from its uv coverage as phase 3's
NX_W = 4608
SIM_W = dict(SIM, duration_h=0.125)
# phase 35: the device counts and their weights against the host builder
CNTOL = 1e-9
PHTOL = 1e-6  # chunked against whole psfhat; float32 dual update vs float64
# phase 27's fluxmop: tests/test_aux_workers.py:38's settings and gate
MOP = dict(backend="pg", epsilon=1e-5, use_psf=True, sigmainv=1e-4,
           gamma=0.9, cg_maxit=100, write=False, verbose=0)
MOP_GATE = 0.6  # MFS residual peak below this share of the MFS dirty peak
FTOL = 1e-7  # the mds against klean's model at the fit points
POST_OUTPUTS = "mMrRiIc"
# phase 28's fwdbwd: tests/test_fwdbwd.py:45-47's settings, 3 majors
FWD = dict(backend="pg", epsilon=1e-5, parametrisation="id",
           rmsfactor=0.3, bases="self,db1", nlevels=2, niter=3)
FWD_GATE = 0.5  # MFS residual peak below this share of the MFS dirty peak
# phase 28's fastim: 4 integrations a snapshot (32 of the 128), one band
SNAP = dict(backend="pg", epsilon=1e-5, integrations_per_image=4,
            channels_per_grid_image=-1, precision="single")
WTOL = 1e-6  # WSUM of the snapshots against the one image, relative
SNAPTOL = 1e-5  # their RESIDUAL sum, of the model-free image's peak


class SmokeFailure(Exception):
    pass


def need(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, reps=5):
    """Median CUDA-event time of fn() in milliseconds (one warm-up)."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def counters():
    """Every kernel wrapper's launch counter, by kernel name."""
    from pfb_tpu_torch.ops import memlab
    from pfb_tpu_torch.ops import pallas_fft as pf
    from pfb_tpu_torch.ops.cfft import (fftx_c2c, fftx_c2c_cluster,
                                        fftx_c2c_cluster_long,
                                        fftx_c2c_cols_long, fftx_c2c_four,
                                        fftx_c2c_four_rows, fftx_c2c_lab,
                                        fftx_c2c_rows, fftx_c2c_rows_long,
                                        fftx_c2c_split)
    from pfb_tpu_torch.ops.pg_stream import (pg_degrid_gs, pg_fold_gs,
                                             pg_spread_gs)
    from pfb_tpu_torch.ops.pgridder import pg_degrid, pg_fold, pg_spread
    from pfb_tpu_torch.ops.psf import (psf_convolve_full, psf_convolve_h,
                                       psf_convolve_h_cg)
    from pfb_tpu_torch.ops.psf import (psf_cols_fwd, psf_cols_inv,
                                       psf_cols_line, psf_rows,
                                       psf_rows_line, psf_stage_cols_fwd,
                                       psf_stage_cols_inv, psf_stage_rows)
    from pfb_tpu_torch.ops.psi import psi_dot, psi_hdot
    # cols_line / rows_line: the PSF stages' shared-memory line kernels
    # (line_fft_kernel and K2's, psf_rows_kernel), off the routes
    return {"K1": psf_convolve_h, "K2": psf_convolve_h_cg, "K3": fftx_c2c,
            "K3c": fftx_c2c_cluster, "K3r": fftx_c2c_rows,
            "K3f": fftx_c2c_four, "K3xl": fftx_c2c_cols_long,
            "K3yl": fftx_c2c_rows_long, "K3cl": fftx_c2c_cluster_long,
            "K3fr": fftx_c2c_four_rows, "K4": pg_spread, "K5": pg_fold,
            "K6": pg_degrid,
            "K7": pg_spread_gs, "K8": pg_fold_gs, "K9": pg_degrid_gs,
            "K10a": psf_stage_cols_fwd, "K10b": psf_stage_rows,
            "K10c": psf_stage_cols_inv, "K10ac": psf_cols_fwd,
            "K10cc": psf_cols_inv, "K10br": psf_rows,
            "K11": psf_convolve_full,
            "K12": pf.psf_convolve_pallas_v3, "K13": pf.psf_convolve_pallas_v2,
            "K14": pf.psf_convolve_pallas_opt, "K15a": pf.v3_cols_fwd,
            "K15b": pf.v3_cols_inv, "L2a": memlab.lab_copy,
            "L2b": fftx_c2c_split, "L2c": fftx_c2c_lab,
            "cols_line": psf_cols_line, "rows_line": psf_rows_line,
            "S1": psi_dot, "S2": psi_hdot}


def bound(nbytes, flops, tc_flops=0.0):
    """(bound_ms, bound_by): the largest of the bytes over the memory
    rate, the FP32 operations over the FP32 rate and the bf16 tensor-core
    operations over the tensor-core rate."""
    tb = nbytes / HBM_BPS
    tf = max(flops / FP32_FLOPS, tc_flops / BF16_TC_FLOPS)
    return 1e3 * max(tb, tf), "bytes" if tb >= tf else "operations"


def fft_flops(n, lines, real=False):
    """5 n log2 n operations for each complex line of length n (half for
    a real line)."""
    return lines * 5.0 * n * math.log2(n) * (0.5 if real else 1.0)


def taps_in(w, k, P):
    """Each visibility's w taps inside planes [0, P) (|p - w| <= k/2)."""
    import torch
    lo = torch.ceil(w - k / 2).clamp(min=0)
    hi = torch.floor(w + k / 2).clamp(max=P - 1)
    return (hi - lo + 1).clamp(min=0)


def gridding_flops(k, ntaps_w):
    """Operations of spreading or degridding visibilities whose w taps
    are ``ntaps_w`` (a tensor): 2 FMAs (4 operations) for each of the
    (k+1)^2 uv taps of each w tap, both components, plus about 8 for each
    of the 3 (k+1) kernel factors."""
    n = float(ntaps_w.numel())
    return float(4.0 * (k + 1) ** 2 * ntaps_w.double().sum()) + \
        n * 24.0 * (k + 1)


def simulate(workdir, nx=NX, sim=SIM, srf=2.0):
    """The simulated observation (an npz measurement set) and its truth;
    field of view of exactly nx cells of 1 / (2 srf uv_max f_max / c), so
    the true model sits on the grid's pixels."""
    import numpy as np

    from pfb_tpu_torch.utils.ms import simulate_ms
    from pfb_tpu_torch.utils.simulation import image_size_for, simulate_obs
    t0 = time.perf_counter()
    obs = simulate_obs(nant=sim["nant"], ntime=sim["ntime"],
                       nchan=sim["nchan"], seed=sim["seed"],
                       extent=sim["extent"],
                       duration_h=sim.get("duration_h", 1.0))
    _, cell = image_size_for(obs, fov_deg=1.0, srf=srf)
    fov = (nx + 0.5) * np.rad2deg(cell)
    ms = str(Path(workdir) / f"sim{nx}.npz")
    model_true, Ix, Iy, nx_sim, cell_rad, _ = simulate_ms(
        ms, fov_deg=fov, srf=srf, **sim)
    need(nx_sim == nx, f"simulated model is {nx_sim}^2, not {nx}^2")
    return dict(ms=ms, model_true=model_true, Ix=Ix, Iy=Iy,
                cell_rad=cell_rad, nvis=obs.uvw.shape[0] * sim["nchan"],
                t_simulate=time.perf_counter() - t0)


def main_path(truth, device, grid=GRID, spot=SPOT):
    """_init -> _grid -> _spotless on ``device``; returns a dict of
    results, stage times and, per stage, every kernel's launches (counts
    set to 0 just before the path and read after each stage)."""
    import numpy as np
    import torch

    from pfb_tpu_torch.workers.grid import _grid
    from pfb_tpu_torch.workers.init import _init
    from pfb_tpu_torch.workers.spotless import _spotless

    cnt = counters()
    res = {"t": {}, "launches": {}, "peak_gb": {}}
    for fn in cnt.values():
        fn.launches = 0

    def peak(stage):
        # the stage's peak device memory (reset at its start)
        if device.type == "cuda":
            res["peak_gb"][stage] = torch.cuda.max_memory_allocated() / 2**30
            torch.cuda.reset_peak_memory_stats()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    xds = _init(ms=truth["ms"], write=False, device=device, **INIT)
    res["t"]["init"] = time.perf_counter() - t0
    peak("init")

    t0 = time.perf_counter()
    dds = _grid(xdsi=xds, write=False, device=device, **grid)
    sync(device)
    res["t"]["grid"] = time.perf_counter() - t0
    res["launches"]["grid"] = {k: fn.launches for k, fn in cnt.items()}
    peak("grid")

    dirty_mfs = sum(ds["DIRTY"] for ds in dds) / \
        sum(float(ds["WSUM"][0]) for ds in dds)
    res["dirty_rms"] = float(np.std(dirty_mfs))
    stats = {}
    t0 = time.perf_counter()
    model, residual = _spotless(ddsi=dds, write=False, device=device,
                                stats=stats, verbose=0, **spot)
    sync(device)
    peak("spotless")
    if device.type == "cuda":
        res["peak_mem_gb"] = max(res["peak_gb"].values())
    res["t"]["spotless"] = time.perf_counter() - t0
    res["launches"]["spotless"] = {
        k: fn.launches - res["launches"]["grid"][k] for k, fn in cnt.items()}
    res.update(stats=stats, model=model, residual=residual, dds=dds,
               xds=xds)
    return res


def wgrid_planes(dds, nx, epsilon):
    """(nw image, nw PSF) of the w-stacking plans of the first dataset."""
    import torch

    from pfb_tpu_torch.ops.wgridder import _plan
    ds = dds[0]
    uvw = torch.as_tensor(ds["UVW"])
    freq = torch.as_tensor(ds["FREQ"])
    c = float(ds["cell_rad"])
    nw_img = _plan(uvw, freq, nx, nx, c, c, 0.0, 0.0, epsilon, True, 2.0)[4]
    nw_psf = _plan(uvw, freq, 2 * nx, 2 * nx, c, c, 0.0, 0.0, epsilon,
                   True, 2.0)[4]
    return nw_img, nw_psf


def _fft2_pruned_plain(xr, xi, Nx, Ny, inverse, pruned_in, pruned_out):
    """Plain counterpart of ops.cfft.fft2_c2c_pruned on any device."""
    from pfb_tpu_torch.ops.cfft import fftx_c2c_plain
    P = xr.shape[0]
    yr, yi = fftx_c2c_plain(xr, xi, N=Nx, inverse=inverse,
                            in_rolled=pruned_in, out_rolled=pruned_out)
    nrow, ncol = yr.shape[-2:]
    yr, yi = fftx_c2c_plain(yr.reshape(P * nrow, ncol, 1),
                            yi.reshape(P * nrow, ncol, 1), N=Ny,
                            inverse=inverse, in_rolled=pruned_in,
                            out_rolled=pruned_out)
    return yr.reshape(P, nrow, -1), yi.reshape(P, nrow, -1)


def _record(name, shape, out, ref, fk, fp, timing, work=None, flib=None,
            reps=5, tol=TOL, fline=None):
    """One kernel-against-plain comparison (max|out - ref| <= tol
    max|ref|), with CUDA-event times of the kernel, its plain version,
    the library call ``flib`` and the line kernel ``fline`` (when given:
    ``line_ms``, the kernel the lengths below 2048 took before the short
    designs), and the bound of ``work`` = (bytes, FP32 operations[, bf16
    tensor-core operations])."""
    import numpy as np
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    r = dict(name=name, shape=list(shape), max_abs_err=err,
             rel_err=err / scale, tol=tol, ok=bool(err <= tol * scale))
    if work is not None:
        r["bound_ms"], r["bound_by"] = bound(*work)
    if timing:
        # alternate plain and kernel so both see the same clocks
        r["plain_ms"] = cuda_ms(fp, reps)
        r["ms"] = cuda_ms(fk, reps)
        r["plain_ms"] = 0.5 * (r["plain_ms"] + cuda_ms(fp, reps))
        r["library_ms"] = None if flib is None else cuda_ms(flib, reps)
        if fline is not None:
            r["line_ms"] = cuda_ms(fline, reps)
    r["max_abs_err"] = float(np.float64(r["max_abs_err"]))
    return r


def _xpass_record(name, xr, xi, N, inv, pin, pout, timing, line=False):
    """K3's x pass on the cluster column kernel (fftx_c2c_cluster) of a
    (P, nin, L) stack against its plain version, with torch.fft along
    dim -2 of the zero-padded (P, N, L) stack as the library call and
    (``line``) line_fft_kernel on the same stack (fftx_c2c_lab)."""
    import torch

    from pfb_tpu_torch.ops.cfft import (cluster_shape, fftx_c2c_cluster,
                                        fftx_c2c_cluster_plain, fftx_c2c_lab)
    kw = dict(N=N, inverse=inv, in_rolled=pin, out_rolled=pout)
    P, nin, L = xr.shape
    out = torch.cat(fftx_c2c_cluster(xr, xi, **kw))
    C = cluster_shape(N)[0]
    ref = torch.cat(fftx_c2c_cluster_plain(xr, xi, C=C, **kw))
    z = torch.zeros((P, N, L), dtype=torch.complex64, device=xr.device)
    z[:, :nin] = torch.complex(xr, xi)
    lib = torch.fft.ifft if inv else torch.fft.fft
    r = _record(f"{name} C={C}", xr.shape, out, ref,
                lambda: fftx_c2c_cluster(xr, xi, **kw),
                lambda: fftx_c2c_cluster_plain(xr, xi, C=C, **kw), timing,
                work=(8 * P * L * (nin + out.shape[1]),
                      P * fft_flops(N, L)),
                flib=lambda: lib(z, dim=-2),
                fline=(lambda: fftx_c2c_lab(xr, xi, **kw)) if line else None)
    del out, ref, z
    return r


def _ypass_record(name, P, N, inv, pin, pout, g, timing, line=False):
    """K3's y pass on the row kernel (fftx_c2c_rows, K3r) of a 2-D
    transform of P (N, N) planes, on the (P * nrow, nin, 1) row stack the
    x pass leaves, against its plain version, with torch.fft along dim
    -2 of the zero-padded (P * nrow, N, 1) stack as the library call and
    (``line``) line_fft_kernel on the same rows (fftx_c2c_lab)."""
    import torch

    from pfb_tpu_torch.ops.cfft import (fftx_c2c, fftx_c2c_lab,
                                        fftx_c2c_rows, fftx_c2c_rows_plain)
    kw = dict(N=N, inverse=inv, in_rolled=pin, out_rolled=pout)
    rows = P * (N if pin else N // 2)
    nin = N // 2 if pin else N
    dev = g.device
    xr = torch.randn((rows, nin, 1), generator=g, device=dev)
    xi = torch.randn((rows, nin, 1), generator=g, device=dev)
    # through fftx_c2c's route (the CPU rehearsal's lengths take the
    # plain transform there)
    r0 = fftx_c2c_rows.launches
    out = torch.cat(fftx_c2c(xr, xi, **kw))
    need(dev.type != "cuda" or fftx_c2c_rows.launches == r0 + 1,
         f"the y pass at N={N} did not take the row kernel")
    ref = torch.cat(fftx_c2c_rows_plain(xr, xi, **kw))
    z = torch.zeros((rows, N, 1), dtype=torch.complex64, device=dev)
    z[:, :nin] = torch.complex(xr, xi)
    lib = torch.fft.ifft if inv else torch.fft.fft
    r = _record(name, xr.shape, out, ref, lambda: fftx_c2c(xr, xi, **kw),
                lambda: fftx_c2c_rows_plain(xr, xi, **kw), timing,
                work=(8 * rows * (nin + out.shape[1]), fft_flops(N, rows)),
                flib=lambda: lib(z, dim=-2),
                fline=(lambda: fftx_c2c_lab(xr, xi, **kw)) if line else None)
    del out, ref, z, xr, xi
    return r


def k1_records(psf, nx, device, g, timing=True):
    """K1 against its plain version on x (nband, nx, nx) from ``g`` with
    the transfer function of the PSF cube ``psf`` (nband, 2nx, 2nx),
    complex and its real even part; returns the two records."""
    import torch

    from pfb_tpu_torch.ops.psf import (prep_h, psf_convolve_h,
                                       psf_convolve_h_plain)
    recs = []
    nband = psf.shape[0]
    psf_t = torch.as_tensor(psf, dtype=torch.float32, device=device)
    x = torch.randn((nband, nx, nx), generator=g, device=device)
    NX = NY = 2 * nx
    for mode in (False, True):
        hr, hi = prep_h(psf_t, nx, nx, torch.float32, real_transfer=mode)
        out = psf_convolve_h(x, hr, hi)
        ref = psf_convolve_h_plain(x, hr, hi)
        # x read, H read, out written; per band a real x transform of
        # each of ny columns and back, a complex y transform of nx + 1
        # rows and back, and the product with H
        nbytes = 4 * (2 * x.numel() + hr.numel()
                      + (0 if hi is None else hi.numel()))
        flops = nband * (fft_flops(NX, 2 * nx, real=True)
                         + fft_flops(NY, 2 * (nx + 1))
                         + (nx + 1) * NY * (2 if hi is None else 6))
        recs.append(_record(
            f"K1 psf_convolve_h {'real' if hi is None else 'complex'}-H "
            f"({nband}, {nx}^2)", x.shape, out, ref,
            lambda: psf_convolve_h(x, hr, hi),
            lambda: psf_convolve_h_plain(x, hr, hi), timing,
            work=(nbytes, flops)))
        del hr, hi, out, ref
    return recs


def line_record(g, device, timing=True, P=9, N=1350):
    """The line kernel (K3) where its route still runs: the x pass of P
    (N, N) planes at a length off the cluster route (N % 4 == 2, so no
    rolled modes; no 128-aligned grid has it), inverse, against its
    plain version and torch.fft."""
    import torch

    from pfb_tpu_torch.ops.cfft import fftx_c2c, fftx_c2c_plain
    xr = torch.randn((P, N, N), generator=g, device=device)
    xi = torch.randn((P, N, N), generator=g, device=device)
    kw = dict(N=N, inverse=True)
    n0 = fftx_c2c.launches
    out = torch.cat(fftx_c2c(xr, xi, **kw))
    need(device.type != "cuda" or fftx_c2c.launches == n0 + 1,
         f"the x pass at N={N} did not take line_fft_kernel")
    ref = torch.cat(fftx_c2c_plain(xr, xi, **kw))
    z = torch.complex(xr, xi)
    r = _record(
        f"K3 x pass inverse ({P}, {N}^2) (line_fft_kernel)",
        xr.shape, out, ref, lambda: fftx_c2c(xr, xi, **kw),
        lambda: fftx_c2c_plain(xr, xi, **kw), timing,
        work=(8 * P * N * 2 * N, P * fft_flops(N, N)),
        flib=lambda: torch.fft.ifft(z, dim=-2))
    del xr, xi, out, ref, z
    return r


def kernel_checks(dds, nx, nw_img, nw_psf, device, timing=True):
    """K1 and K3 against their plain versions on the same inputs (K3 as
    the 2-D transform, its x pass alone on the cluster column kernel
    K3c, its y pass alone on the row kernel K3r, and the line kernel on
    the x pass of (9, 1350^2), where its route still runs); returns one
    record per comparison."""
    import torch

    from pfb_tpu_torch.ops.cfft import fft2_c2c_pruned
    from pfb_tpu_torch.workers.cubes import dds2cubes

    nband = max(ds["bandid"] for ds in dds) + 1
    g = torch.Generator(device=device).manual_seed(1)
    recs = k1_records(dds2cubes(dds, nband)[3], nx, device, g, timing)
    recs.append(line_record(g, device, timing))
    if device.type == "cuda":
        torch.cuda.empty_cache()

    N = 2 * nx
    cases = [("K3 fft2 pruned_out inverse (image grids)", nw_img, N, True,
              False, True),
             ("K3 fft2 pruned_in forward (image grids)", nw_img, N, False,
              True, False),
             ("K3 fft2 pruned_out inverse (PSF grids, 4 planes)",
              min(4, nw_psf), 2 * N, True, False, True),
             ("K3 fft2 pruned_in forward (blocked residual, 4 planes)", 4,
              2 * N, False, True, False)]
    for name, P, Ng, inv, pin, pout in cases:
        nin = Ng // 2 if pin else Ng
        xr = torch.randn((P, nin, nin), generator=g, device=device)
        xi = torch.randn((P, nin, nin), generator=g, device=device)
        recs.append(_xpass_record(name.replace("K3 fft2", "K3c x pass"),
                                  xr, xi, Ng, inv, pin, pout, timing))
        recs.append(_ypass_record(name.replace("K3 fft2", "K3r y pass"), P,
                                  Ng, inv, pin, pout, g, timing))
        kw = dict(Nx=Ng, Ny=Ng, inverse=inv)
        yr, yi = fft2_c2c_pruned(xr, xi, pruned_in=pin, pruned_out=pout,
                                 **kw)
        rr, ri = _fft2_pruned_plain(xr, xi, Ng, Ng, inv, pin, pout)
        out = torch.complex(yr, yi)
        ref = torch.complex(rr, ri)
        nout = out.shape[-1]
        del yr, yi, rr, ri
        # the library call: one torch.fft over the zero-padded stack
        zpad = torch.zeros((P, Ng, Ng), dtype=torch.complex64,
                           device=device)
        zpad[:, :nin, :nin] = torch.complex(xr, xi)
        flib = torch.fft.ifft2 if inv else torch.fft.fft2
        recs.append(_record(
            name, (P, nin, nin), out, ref,
            lambda: fft2_c2c_pruned(xr, xi, pruned_in=pin,
                                    pruned_out=pout, **kw),
            lambda: _fft2_pruned_plain(xr, xi, Ng, Ng, inv, pin, pout),
            timing, work=(8 * P * (nin ** 2 + nout ** 2),
                          P * fft_flops(Ng, nin + nout)),
            flib=lambda: flib(zpad)))
        del out, ref, xr, xi, zpad
        if device.type == "cuda":
            torch.cuda.empty_cache()
    # K3r at the K11 path's lengths: its image grids (3 nx)^2 and PSF
    # grids (6 nx)^2
    for P, Ng in ((8, 3 * nx), (2, 6 * nx)):
        recs.append(_ypass_record(
            f"K3r y pass inverse pruned_out ({P}, {Ng}^2)", P, Ng, True,
            False, True, g, timing))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return recs


def _wtaps(w, live, k, P):
    """The w taps in planes [0, P) of each live visibility (one each
    without w gridding, ``w`` None)."""
    import torch
    if w is None:
        return torch.ones(int(live.sum()), device=live.device)
    return taps_in(w[live], k, P)


def spread_work(w, live, k, P, nslots, Thx, Thy):
    """(bytes, operations) of a spread of (entries, C) visibilities:
    positions (rows 0-2), weighted visibilities and slot ranges read
    once, the live slots' (2, P, Thx, Thy) blocks written once. ``w``:
    the visibilities' w coordinates relative to the first of the P
    planes (None without w gridding); ``live``: their mask."""
    ne, C = live.shape
    nbytes = 4 * (5 * ne * C + ne + 2 * nslots + 2 * P * nslots * Thx * Thy)
    return nbytes, gridding_flops(k, _wtaps(w, live, k, P))


def spread_parts(kw, design="lists", reps=5):
    """The spread's time by parts: CUDA-event medians of the kernel and of
    its skeletons (``pg_stream.pg_spread_lab`` on the operands ``kw``,
    one of its designs) and the differences of consecutive ones: the
    accumulation (fma), the warps' scan of their candidates, the factor
    evaluation, the loads, and the barriers with the launch; and the
    kernel on the slot with the most entries alone, the others empty (the
    time its chain takes, which no other slot's work can hide)."""
    import torch

    from pfb_tpu_torch.ops import pg_stream as pgs
    t = {m: cuda_ms(lambda m=m: pgs.pg_spread_lab(design=design, mode=m,
                                                  **kw), reps)
         for m in pgs.SPREAD_MODES}
    # the imbalance: the longest slot's chain alone (the others empty)
    cnt = kw["count"]
    alone = torch.where(torch.arange(cnt.numel(), device=cnt.device)
                        == cnt.argmax(), cnt, torch.zeros_like(cnt))
    t["longest slot alone"] = cuda_ms(lambda: pgs.pg_spread_lab(
        design=design, **dict(kw, count=alone)), reps)
    return dict(design=design, ms=t, split={
        "fma": t["kernel"] - t["no FMA"], "scan": t["no FMA"] - t["no scan"],
        "factors": t["no scan"] - t["no factors"],
        "loads": t["no factors"] - t["barriers"], "barriers": t["barriers"]})


def degrid_parts(kw, design="window", reps=5):
    """The degrid's time by parts: CUDA-event medians of the kernel and of
    its skeletons (``pg_stream.pg_degrid_lab`` on the operands ``kw``,
    one of its designs): the tap factors alone, the grid loads alone, and
    the sums on register data (with the design's exchange of the taps
    between lanes). K9's skeletons add to a copy of ``kw``'s
    accumulator."""
    from pfb_tpu_torch.ops import pg_stream as pgs
    if kw.get("acc") is not None:
        kw = dict(kw, acc=kw["acc"].clone())
    return dict(design=design, ms={
        m: cuda_ms(lambda m=m: pgs.pg_degrid_lab(design=design, mode=m,
                                                 **kw), reps)
        for m in pgs.DEGRID_MODES})


def chains(count):
    """A spread's slot chains: live slots, entries, the longest chain and
    the mean (entries a live slot); the blocks of the longest slot run
    its chain one entry after another."""
    c = count[count > 0].double()
    return dict(live_slots=int(c.numel()), entries=int(c.sum()),
                longest=int(c.max()), mean=float(c.mean()))


def degrid_work(w, live, k, P, ntiles, Thx, Thy, Nx, Ny, accumulate=False):
    """(bytes, operations) of a degrid: positions and tile ids read once,
    the grid points under the ``ntiles`` live tiles' windows (both
    components, P planes) read once, the visibilities written once (and
    read, when they are accumulated)."""
    ne, C = live.shape
    npts = min(ntiles * Thx * Thy, Nx * Ny)
    nbytes = 4 * (3 * ne * C + ne + 2 * P * npts
                  + (4 if accumulate else 2) * ne * C)
    return nbytes, gridding_flops(k, _wtaps(w, live, k, P))


def fold_work(nq, nslots, Thx, Thy, ntiles, Nx, Ny):
    """(bytes, operations) of a fold: the live blocks and the tile table
    read once, the grids written once; one add per block element."""
    nel = nq * nslots * Thx * Thy
    return 4 * (nel + ntiles + nq * Nx * Ny), float(nel)


def fold_library(Y, tile, live, nty, txs, tys, k, Nx, Ny):
    """The fold from scratch in PyTorch calls: a zero fill of the (nq,
    Nx * Ny) grids, then one ``index_add_`` of the live slots of Y (nq,
    NS, Thx, Thy). The indices and the source are made here, outside
    the timed call."""
    import torch
    nq, _, Thx, Thy = Y.shape
    dev = Y.device
    t = tile[live].long()
    X = torch.remainder(((t // nty) * txs - k // 2)[:, None]
                        + torch.arange(Thx, device=dev), Nx)
    Yi = torch.remainder(((t % nty) * tys - k // 2)[:, None]
                         + torch.arange(Thy, device=dev), Ny)
    flat = (X[:, :, None] * Ny + Yi[:, None, :]).reshape(-1)
    src = Y[:, live].reshape(nq, -1).contiguous()
    out = torch.empty((nq, Nx * Ny), dtype=Y.dtype, device=dev)
    return lambda: out.zero_().index_add_(1, flat, src)


def pg_plans(ds, nx, epsilon, device):
    """The pg plans of one dataset's image (nx^2) and PSF ((2 nx)^2), as
    _grid makes them (rows padded to the row bucket)."""
    import numpy as np

    from pfb_tpu_torch.ops.gridder import row_bucket
    from pfb_tpu_torch.ops.pgridder import pgrid_plan
    uvw = np.asarray(ds["UVW"], np.float64)
    uvw = np.pad(uvw, ((0, row_bucket(uvw.shape[0]) - uvw.shape[0]),
                       (0, 0)))
    c = float(ds["cell_rad"])
    return [pgrid_plan(uvw, ds["FREQ"], nx=n, ny=n, cellx=c, celly=c,
                       epsilon=epsilon, device=device)
            for n in (nx, 2 * nx)]


def plan_summary(p):
    return dict(k=p["k"], nw=p["nw"], Nx=p["Nx"], tiles=[p["txs"], p["tys"]],
                ntiles=p["ntx"] * p["nty"], entries=p["nentries"])


def pg_kernel_checks(res, nx, epsilon, device, timing=True):
    """K4, K5 (alone and chained) on one dataset's image and PSF plans
    with its weighted visibilities, K6 on the image plan with the w-plane
    grids of the pg path's band-0 model; returns (records, plans)."""
    import torch

    from pfb_tpu_torch.ops import pgridder as pg
    from pfb_tpu_torch.ops.wgridder import _image_to_grid

    ds, xds0 = res["dds"][0], res["xds"][0]
    plans = pg_plans(ds, nx, epsilon, device)
    recs = []
    for label, p in zip(("image", "PSF"), plans):
        k, nw, txs, tys = p["k"], p["nw"], p["txs"], p["tys"]
        Thx, Thy = txs + k, tys + k
        nrow = ds["UVW"].shape[0]
        vis = torch.as_tensor(xds0["VIS"]).to(device)
        if label == "PSF":
            vis = torch.ones_like(vis)
        w = torch.zeros((p["nrow"], p["nchan"]), dtype=p["rdtype"],
                        device=device)
        w[:nrow] = torch.as_tensor(ds["WEIGHT"] * ds["MASK"]).to(w)
        vr = torch.zeros_like(w)
        vi = torch.zeros_like(w)
        vr[:nrow], vi[:nrow] = vis.real.to(w), vis.imag.to(w)
        ix = p["idx"].long()
        vr, vi = (vr * w).reshape(-1), (vi * w).reshape(-1)
        vis = torch.stack([vr[ix] * p["pm"], vi[ix] * p["pm"]],
                          dim=1).contiguous()
        slots = pg._compact_slots(p["tid"], p["pm"], p["ntx"], p["nty"],
                                  txs, tys, k)
        skw = dict(beta=p["beta"], k=k, nw=nw, Thx=Thx, Thy=Thy)
        fkw = dict(nty=p["nty"], txs=txs, tys=tys, k=k, Nx=p["Nx"],
                   Ny=p["Ny"])
        shape = (2 * nw, slots["NS"], Thx, Thy)

        def spread_k():
            return pg.pg_spread(p["pos"], vis, slots, **skw).reshape(shape)

        def spread_p():
            return pg.pg_spread_plain(p["pos"], vis, slots,
                                      **skw).reshape(shape)

        def fold_k(Y):
            return pg.pg_fold(Y, slots, ntx=p["ntx"], **fkw)

        def fold_p(Y):
            return pg.pg_fold_plain(Y, slots, **fkw)

        Yk, Yp = spread_k(), spread_p().contiguous()
        live = slots["live"]  # the kernel writes live slots only
        work = spread_work(p["pos"][:, 2] if nw > 1 else None,
                           p["pm"] != 0, k, nw, int(live.sum()), Thx, Thy)
        recs.append(_record(f"K4 pg_spread ({label} plan)", shape,
                            Yk[:, live], Yp[:, live], spread_k, spread_p,
                            timing, work=work))
        if timing and k == 7:
            print(f"[spread] K4 {label} plan: " + json.dumps(dict(
                chains(slots["count"]), **spread_parts(dict(
                    pos=p["pos"], vis=vis, start=slots["start"],
                    count=slots["count"], **skw)))), flush=True)
        del Yk
        Gk, Gp = fold_k(Yp), fold_p(Yp)
        recs.append(_record(
            f"K5 pg_fold ({label} plan)", Gp.shape, Gk, Gp,
            lambda: fold_k(Yp), lambda: fold_p(Yp), timing,
            work=fold_work(Yp.shape[0], int(live.sum()), Thx, Thy,
                           p["ntx"] * p["nty"], p["Nx"], p["Ny"]),
            flib=fold_library(Yp, slots["tile"], live, p["nty"], txs, tys,
                              k, p["Nx"], p["Ny"])))
        del Gk, Gp, Yp
        Gk, Gp = fold_k(spread_k()), fold_p(spread_p())
        recs.append(_record(f"K4+K5 grids ({label} plan)", Gp.shape, Gk, Gp,
                            None, None, False))
        del Gk, Gp, vis, slots
        if device.type == "cuda":
            torch.cuda.empty_cache()

    p = plans[0]
    model = torch.as_tensor(res["model"][0], dtype=p["rdtype"],
                            device=device)
    gr, gi = _image_to_grid(model, nx, nx, p["cellx"], p["celly"], p["k"],
                            p["beta"], p["Nx"], p["Ny"], p["nw"] > 1,
                            p["nw"], float(p["w0"]), float(p["dw"]), False)
    gr, gi = gr.contiguous(), gi.contiguous()
    dkw = dict(beta=p["beta"], k=p["k"], nw=p["nw"], txs=p["txs"],
               tys=p["tys"], nty=p["nty"])

    def degrid_k():
        return pg.pg_degrid(gr, gi, p["pos"], p["tid"], **dkw)

    def degrid_p():
        return pg.pg_degrid_plain(gr, gi, p["pos"], p["tid"], **dkw)

    live = p["pm"] != 0
    ntiles = int(torch.unique(p["tid"][live.any(dim=1)]).numel())
    work = degrid_work(p["pos"][:, 2] if p["nw"] > 1 else None, live,
                       p["k"], p["nw"], ntiles, p["txs"] + p["k"],
                       p["tys"] + p["k"], p["Nx"], p["Ny"])
    recs.append(_record("K6 pg_degrid (image plan, model grids)",
                        (p["nentries"], 2, p["C"]), degrid_k(), degrid_p(),
                        degrid_k, degrid_p, timing, work=work))
    if timing and p["k"] == 7:
        lkw = dict(gr=gr, gi=gi, pos=p["pos"], tid=p["tid"], **dkw)
        print("[degrid] K6 image plan: " + json.dumps(
            {d: degrid_parts(lkw, d) for d in ("window", "thread")}),
            flush=True)
    return recs, plans


def pg_cross_check(res, nx, epsilon, device):
    """max|pg - wgrid| / max|wgrid| of one dataset's dirty image, same
    visibilities and weights, both float32 on ``device``."""
    import torch

    from pfb_tpu_torch.ops.pgridder import vis2dirty_pg
    from pfb_tpu_torch.ops.wgridder import vis2dirty_wgrid
    ds, xds0 = res["dds"][0], res["xds"][0]
    rdt = torch.float32 if device.type == "cuda" else torch.float64
    uvw = torch.as_tensor(ds["UVW"]).to(device)
    freq = torch.as_tensor(ds["FREQ"]).to(device)
    vis = torch.as_tensor(xds0["VIS"]).to(device)
    vis = vis.to(torch.complex64 if rdt == torch.float32 else
                 torch.complex128)
    wgt = torch.as_tensor(ds["WEIGHT"] * ds["MASK"]).to(device, rdt)
    c = float(ds["cell_rad"])
    kw = dict(nx=nx, ny=nx, cellx=c, celly=c, epsilon=epsilon)
    a = vis2dirty_pg(uvw, freq, vis, wgt=wgt, **kw)
    b = vis2dirty_wgrid(uvw, freq, vis, wgt=wgt, **kw)
    return float((a - b).abs().max() / b.abs().max())


def source_checks(res, truth, nbright=3):
    """The brightest true sources: model flux at their pixels, and the
    model's local maximum (5x5) there."""
    import numpy as np
    true_mfs = truth["model_true"].sum(axis=0)
    model_mfs = res["model"].sum(axis=0)
    flux = true_mfs[truth["Ix"], truth["Iy"]]
    out = []
    for s in np.argsort(flux)[::-1][:nbright]:
        i, j = int(truth["Ix"][s]), int(truth["Iy"][s])
        win = model_mfs[max(i - 2, 0):i + 3, max(j - 2, 0):j + 3]
        out.append(dict(pixel=[i, j], true=float(flux[s]),
                        model=float(model_mfs[i, j]),
                        local_max=bool(model_mfs[i, j] > 0
                                       and model_mfs[i, j] >= win.max())))
    return out


def report_path(tag, res, truth, nx):
    """Print a path's stage times, memory, residuals and launches; check
    its image and return its source records."""
    import numpy as np
    st = res["stats"]
    print(f"[{tag}] stage seconds " + json.dumps(
        {k: round(v, 3) for k, v in res["t"].items()}))
    print(f"[{tag}] peak device memory {res['peak_mem_gb']:.2f} GiB; by "
          "stage " + json.dumps({k: round(v, 3)
                                 for k, v in res.get("peak_gb", {}).items()}))
    print(f"[{tag}] hessnorm {st['hessnorm']:.6e}, engine {st['engine']}; "
          f"dirty MFS rms {res['dirty_rms']:.6e}")
    for k, (r, m, n) in enumerate(zip(st["rms"], st["rmax"],
                                      st["pd_iters"])):
        print(f"[{tag}] major {k + 1}: MFS residual rms {r:.6e}, "
              f"peak {m:.6e}, pd iters {n}")
    print(f"[{tag}] launches " + json.dumps(res["launches"]))
    srcs = source_checks(res, truth)
    for s in srcs:
        print(f"[{tag}] source {s}")
    need(all(np.isfinite(v) for v in st["rms"]) and
         np.isfinite(res["model"]).all(), f"{tag}: non-finite model/residual")
    need(res["model"].shape == (len(res["dds"]), nx, nx),
         f"{tag}: model shape {res['model'].shape}")
    need(st["rms"][-1] < res["dirty_rms"],
         f"{tag}: residual rms {st['rms'][-1]} not below dirty rms "
         f"{res['dirty_rms']}")
    need(all(s["local_max"] for s in srcs),
         f"{tag}: bright sources not recovered at their pixels: {srcs}")
    return srcs


def klean_path(rpg, device):
    """_klean on copies of the pg path's dds (its xds and gridding
    reused); returns a dict like main_path's, every kernel's launches in
    the klean stage (counts set to 0 just before and read just after)."""
    import torch

    from pfb_tpu_torch.workers.klean import _klean
    cnt = counters()
    for fn in cnt.values():
        fn.launches = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    dds = [dict(ds) for ds in rpg["dds"]]
    stats = {}
    t0 = time.perf_counter()
    model, residual = _klean(ddsi=dds, write=False, device=device,
                             stats=stats, verbose=0, **KLEAN)
    sync(device)
    res = dict(t={"klean": time.perf_counter() - t0},
               launches={"klean": {k: fn.launches for k, fn in cnt.items()}},
               stats=stats, model=model, residual=residual, dds=dds,
               dirty_rms=rpg["dirty_rms"])
    if device.type == "cuda":
        res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    return res


def blocked_summary(bp):
    p0 = bp["p0"]
    return dict(k=p0["k"], nw=bp["nw"], nblocks=bp["nblocks"], B=bp["B"],
                Nx=p0["Nx"], NEg=bp["NEg"], C=p0["C"],
                tiles=[p0["txs"], p0["tys"]], NT=bp["NT"],
                entries_per_block=[int(n) for n in bp["nelive"]])


def gs_kernel_checks(bp, vr, vi, w, image, label, timing=True, reps=5):
    """K7, K8 and K9 against their plain versions on the block of ``bp``
    with the most entries: the spread of the weighted visibilities (vr,
    vi, weights w), the fold of its slots, the degrid of the block's
    grids of ``image``."""
    import torch

    from pfb_tpu_torch.ops import pg_stream as pgs
    from pfb_tpu_torch.ops.wgridder import _image_to_grid
    p0 = bp["p0"]
    k, B, NT = p0["k"], bp["B"], bp["NT"]
    txs, tys = p0["txs"], p0["tys"]
    Thx, Thy = txs + k, tys + k
    b = int(bp["nelive"].argmax())
    ne = int(bp["nelive"][b])
    gmap = bp["gmap"][b, :ne]
    woff = int(bp["woff"][b, 0])
    st, ct, tslot = bp["start"][b], bp["count"][b], bp["tslot"][b]
    vis = pgs._weighted_vispack(bp, vr, vi, w)
    g = gmap.long()
    wrel = bp["pos"][g, 2] - woff
    live = bp["gpm"][g] != 0
    nslots = int((ct > 0).sum())
    tag = f"({label}, block {b} of {bp['nblocks']}, {ne} entries)"
    recs = []

    skw = dict(woff=woff, beta=p0["beta"], k=k, B=B, Thx=Thx, Thy=Thy)

    def spread_k():
        return pgs.pg_spread_gs(bp["pos"], vis, gmap, st, ct, **skw)

    def spread_p():
        return pgs.pg_spread_gs_plain(bp["pos"], vis, gmap, st, ct, **skw)

    Yk, Yp = spread_k(), spread_p()
    sl = ct > 0  # the kernel writes the slots with entries only
    recs.append(_record(f"K7 pg_spread_gs {tag}", Yp.shape, Yk[:, :, sl],
                        Yp[:, :, sl], spread_k, spread_p, timing,
                        work=spread_work(wrel, live, k, B, nslots, Thx,
                                         Thy), reps=reps))
    if timing and k == 7:
        print(f"[spread] K7 {tag}: " + json.dumps(dict(
            chains(ct), **spread_parts(dict(
                pos=bp["pos"], vis=vis, start=st, count=ct, gmap=gmap,
                woff=woff, beta=p0["beta"], k=k, nw=B, Thx=Thx, Thy=Thy),
                reps=reps))), flush=True)
    del Yk
    Y = Yp.reshape(2 * B, NT, Thx, Thy).contiguous()
    del Yp
    fkw = dict(nty=p0["nty"], txs=txs, tys=tys, k=k, Nx=p0["Nx"],
               Ny=p0["Ny"])

    def fold_k():
        return pgs.pg_fold_gs(Y, tslot, ntx=p0["ntx"], **fkw)

    def fold_p():
        return pgs.pg_fold_gs_plain(Y, tslot, **fkw)

    tile = torch.zeros(NT, dtype=torch.long, device=Y.device)
    inb = tslot >= 0
    tile[tslot[inb].long()] = torch.arange(tslot.numel(),
                                           device=Y.device)[inb]
    recs.append(_record(f"K8 pg_fold_gs {tag}", (2 * B, p0["Nx"], p0["Ny"]),
                        fold_k(), fold_p(), fold_k, fold_p, timing,
                        work=fold_work(2 * B, nslots, Thx, Thy,
                                       tslot.numel(), p0["Nx"], p0["Ny"]),
                        flib=fold_library(Y, tile, sl, p0["nty"], txs, tys,
                                          k, p0["Nx"], p0["Ny"]),
                        reps=reps))
    del Y

    gr, gi = _image_to_grid(image.to(p0["rdtype"]), p0["nx"], p0["ny"],
                            p0["cellx"], p0["celly"], k, p0["beta"],
                            p0["Nx"], p0["Ny"], True, B,
                            float(bp["w0s"][b]), float(bp["dw"]), False,
                            p0["x0"], p0["y0"])
    gr, gi = gr.contiguous(), gi.contiguous()
    dkw = dict(woff=woff, beta=p0["beta"], k=k, B=B, txs=txs, tys=tys,
               nty=p0["nty"])
    acc_shape = (bp["NEg"] + 1, 2, p0["C"])
    acc_t = torch.zeros(acc_shape, dtype=gr.dtype, device=gr.device)
    gpm = bp["gpm"][:, None]

    def degrid(fn, acc):
        return fn(gr, gi, bp["pos"], bp["utid"], gmap, acc, **dkw)

    out = degrid(pgs.pg_degrid_gs, torch.zeros_like(acc_t)) * gpm
    ref = degrid(pgs.pg_degrid_gs_plain, torch.zeros_like(acc_t)) * gpm
    recs.append(_record(
        f"K9 pg_degrid_gs {tag}", acc_shape, out, ref,
        lambda: degrid(pgs.pg_degrid_gs, acc_t),
        lambda: degrid(pgs.pg_degrid_gs_plain, acc_t), timing,
        work=degrid_work(wrel, live, k, B, nslots, Thx, Thy, p0["Nx"],
                         p0["Ny"], accumulate=True), reps=reps))
    if timing and k == 7:
        lkw = dict(gr=gr, gi=gi, pos=bp["pos"], tid=bp["utid"], gmap=gmap,
                   acc=acc_t, woff=woff, beta=p0["beta"], k=k, nw=B, txs=txs,
                   tys=tys, nty=p0["nty"])
        print(f"[degrid] K9 {tag}: " + json.dumps(
            {d: degrid_parts(lkw, d, reps) for d in ("window", "thread")}),
            flush=True)
    return recs


def blocked_checks(rpg, nx, device, timing=True):
    """The blocked residual operator (plane_block=4) against the
    all-planes one on one pg dataset and the pg path's model, and K7-K9
    against plain on its largest block; returns (relative difference,
    the blocked plan's summary, records)."""
    import torch

    from pfb_tpu_torch.ops.gridder import make_hessian_dds
    ds = dict(rpg["dds"][0], bandid=0)
    rdt = torch.float32 if device.type == "cuda" else torch.float64
    x = torch.as_tensor(rpg["model"][rpg["dds"][0]["bandid"]][None]).to(
        device, rdt)
    kw = dict(backend="pg", epsilon=KLEAN["epsilon"], use_beam=False,
              device=device)
    hb = make_hessian_dds([ds], 1, 1.0, nx, nx,
                          plane_block=KLEAN["plane_block"], **kw)
    yb = hb(x)
    yu = make_hessian_dds([ds], 1, 1.0, nx, nx, plane_block=None, **kw)(x)
    err = float((yb - yu).abs().max() / yu.abs().max())
    del yb, yu
    bp = hb.plans[0]
    vis = torch.as_tensor(rpg["xds"][0]["VIS"]).to(device)
    w = torch.as_tensor(ds["WEIGHT"] * ds["MASK"]).to(device, rdt)
    recs = gs_kernel_checks(bp, vis.real.to(rdt), vis.imag.to(rdt), w, x[0],
                            f"{nx}^2 klean dataset 0", timing=timing)
    return err, blocked_summary(bp), recs


def flagship(device, cfg=FLAGSHIP, timing=True, reps=3):
    """bench.py's flagship operator through the blocked engine and
    through all planes at once: host plan seconds, adjoint and Hessian
    seconds (median of ``reps`` after a warm-up, host clock ending in a
    synchronise), Mvis/s, peak device memory and every kernel's launches
    (counts set to 0 just before each and read just after) of each,
    their relative difference, and K7-K9 against plain on the largest
    block."""
    import numpy as np
    import torch

    from pfb_tpu_torch.ops.gridder import make_hessian_dds
    from pfb_tpu_torch.ops.pg_stream import make_adjoint_pg_wblocked
    from pfb_tpu_torch.ops.pgridder import _adjoint_from_plan, plan_consts
    rng = np.random.default_rng(cfg["seed"])
    nrow, nchan, nx = cfg["nrow"], cfg["nchan"], cfg["nx"]
    uvw = rng.normal(scale=1000.0, size=(nrow, 3))
    uvw[:, 2] *= 0.1
    freq = np.linspace(0.9e9, 1.1e9, nchan)
    umax = np.abs(uvw[:, :2]).max() * freq[-1] / 299792458.0
    cell = 1.0 / (2.0 * umax * 2.0)
    nvis = nrow * nchan
    vr = torch.as_tensor(rng.normal(size=(nrow, nchan)).astype(
        np.float32)).to(device)
    vi = torch.as_tensor(rng.normal(size=(nrow, nchan)).astype(
        np.float32)).to(device)
    ds = dict(UVW=uvw, FREQ=freq, WEIGHT=np.ones((nrow, nchan), np.float32),
              MASK=np.ones((nrow, nchan), np.float32), bandid=0,
              cell_rad=cell)

    def timed(fn, *args):
        out = fn(*args)
        sync(device)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn(*args)
            sync(device)
            ts.append(time.perf_counter() - t0)
        return out, sorted(ts)[len(ts) // 2]

    out, imgs = {}, {}
    cnt = counters()
    for label, pb in (("blocked", cfg["plane_block"]), ("all planes", None)):
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        for fn in cnt.values():
            fn.launches = 0
        t0 = time.perf_counter()
        hess = make_hessian_dds([ds], 1, 1.0, nx, nx, backend="pg",
                                epsilon=cfg["epsilon"], plane_block=pb,
                                use_beam=False, device=device)
        sync(device)
        t_plan = time.perf_counter() - t0
        p = hess.plans[0]
        if pb:
            adj = make_adjoint_pg_wblocked(p)
        else:
            def adj(a, b, p=p, consts=plan_consts(p)):
                return _adjoint_from_plan(p, a, b, None, consts=consts)
        img, t_adj = timed(adj, vr, vi)
        himg, t_hess = timed(hess, img[None])
        r = dict(plan_s=t_plan, adjoint_s=t_adj, hessian_s=t_hess,
                 adjoint_Mvis_s=nvis / t_adj / 1e6,
                 hessian_Mvis_s=nvis / t_hess / 1e6)
        if pb:
            r["plan"] = blocked_summary(p)
        else:
            r["plan"] = dict(k=p["k"], nw=p["nw"], Nx=p["Nx"],
                             entries=p["nentries"], C=p["C"],
                             tiles=[p["txs"], p["tys"]])
        if device.type == "cuda":
            r["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
        r["launches"] = {k: fn.launches for k, fn in cnt.items()}
        out[label] = r
        imgs[label] = (img, himg[0])
        if pb:
            bp = p
        del hess, adj, p
    (ab, hb), (au, hu) = imgs["blocked"], imgs["all planes"]
    out["adjoint_rel_diff"] = float((ab - au).abs().max() / au.abs().max())
    out["hessian_rel_diff"] = float((hb - hu).abs().max() / hu.abs().max())
    del imgs, au, hu, hb
    if device.type == "cuda":
        torch.cuda.empty_cache()
    recs = gs_kernel_checks(bp, vr, vi, None, ab, f"flagship {nx}^2",
                            timing=timing, reps=reps)
    return out, recs


def conv_work(nb, nx, ny, NX, NY, hr_numel, complex_h, extra=0):
    """(bytes, operations) of a padded PSF convolution of an (nb, nx, ny)
    cube: x read, H (``hr_numel`` elements, twice for a complex H) read,
    out written, plus ``extra`` cube passes of 4 bytes an element; per
    band a real x transform of each of ny columns and back, a complex y
    transform of NX/2 + 1 rows and back, the product with H."""
    nxh = NX // 2 + 1
    nbytes = 4 * ((2 + extra) * nb * nx * ny
                  + hr_numel * (2 if complex_h else 1))
    flops = nb * (fft_flops(NX, 2 * ny, real=True) + fft_flops(NY, 2 * nxh)
                  + nxh * NY * (6 if complex_h else 2))
    return nbytes, flops


def k11_kernel_checks(dds, nx, device, timing=True):
    """K11 against its plain version: the phase-12 grid PSF's full
    transfer function at (nband, nx^2), and a random non-Hermitian H at
    psf_oversize 1.5 on two bands."""
    import torch

    from pfb_tpu_torch.ops.fft import good_even_size
    from pfb_tpu_torch.ops.psf import (prep_h_full, psf_convolve_full,
                                       psf_convolve_full_plain)
    from pfb_tpu_torch.workers.cubes import dds2cubes
    nband = max(ds["bandid"] for ds in dds) + 1
    psf_t = torch.as_tensor(dds2cubes(dds, nband)[3], dtype=torch.float32,
                            device=device)
    hr, hi = prep_h_full(psf_t, torch.float32)
    NX, NY = psf_t.shape[-2:]
    del psf_t
    g = torch.Generator(device=device).manual_seed(12)
    x = torch.randn((nband, nx, nx), generator=g, device=device)

    def record(label, xs, hr, hi):
        return _record(
            f"K11 psf_convolve_full ({xs.shape[0]}, {nx}^2) in "
            f"{hr.shape[-2]}x{hr.shape[-1]}, {label}", xs.shape,
            psf_convolve_full(xs, hr, hi), psf_convolve_full_plain(xs, hr, hi),
            lambda: psf_convolve_full(xs, hr, hi),
            lambda: psf_convolve_full_plain(xs, hr, hi), timing,
            work=conv_work(xs.shape[0], nx, nx, *hr.shape[-2:], hr.numel(),
                           True))

    recs = [record("grid PSF", x, hr, hi)]
    del hr, hi
    if device.type == "cuda":
        torch.cuda.empty_cache()
    N15 = good_even_size(int(1.5 * nx))
    hr = torch.randn((2, N15, N15), generator=g, device=device)
    recs.append(record("random H", x[:2].contiguous(), hr,
                       torch.randn_like(hr)))
    return recs, (NX, NY)


def pcg_rate(fn, niter, device):
    """PCG iterations a second of one solve after a warm-up solve (host
    clock ending in a synchronise)."""
    fn()
    sync(device)
    t0 = time.perf_counter()
    fn()
    sync(device)
    return niter / (time.perf_counter() - t0)


def k2_checks(psf, wsums, model, device, timing=True, pcg=PCG):
    """Phase 14: the CG-fused solve on K2 against pcg_bands on K1 with the
    grid-phase PSF cube ``psf`` (nband, 2nx, 2nx), wsum shares and
    sigmainv 1e-2 (25 iterations), K2 against plain there; then bench.py's
    PCG case (``pcg``; None: not run, phase 26): K1 and K2 against plain,
    and the PCG rates of the fused solve, pcg_bands and
    pcg_bands_hostloop, with every kernel's launches counted over those
    solves alone. For each K2 case, its column and rows routes, whether
    its conv is K1's of its own p and its reruns are bit for bit, and its
    stages' times (bench case, or the grid PSF's without one). Returns
    (relative error, records, rates, launches, K2's cases)."""
    import torch

    from pfb_tpu_torch.ops.cfft import cluster_shape
    from pfb_tpu_torch.ops.psf import (cols_route, make_psf_convolve_pallas,
                                       psf_cg_stages, psf_convolve_h,
                                       psf_convolve_h_cg,
                                       psf_convolve_h_cg_plain,
                                       psf_convolve_h_plain, rows_route)
    from pfb_tpu_torch.opt.pcg import (make_pcg_bands_fused, pcg_bands,
                                       pcg_bands_hostloop)
    nb, nx = psf.shape[0], psf.shape[-1] // 2
    ws = torch.as_tensor(wsums / wsums.sum(), dtype=torch.float32,
                         device=device)[:, None, None]
    conv = make_psf_convolve_pallas(
        torch.as_tensor(psf, dtype=torch.float32, device=device), nx, nx,
        sigmainv=1e-2, wsum=ws)
    b = conv(torch.as_tensor(model, dtype=torch.float32, device=device))
    x0 = torch.zeros_like(b)
    x_ref = pcg_bands(conv, b, x0=x0, tol=0.0, maxit=25)
    x_cg = make_pcg_bands_fused(conv.apply, tol=0.0, maxit=25,
                                apply_cg=conv.apply_cg,
                                cg_scale=conv.cg_scale)(b, x0, conv.consts)
    err = float((x_cg - x_ref).abs().max() / x_ref.abs().max())
    del x_ref, x_cg, b, x0

    g = torch.Generator(device=device).manual_seed(14)
    recs = []
    k2_info = {}

    def cg_records(tag, hr, hi, nb, nx, timing):
        pp, r = (torch.randn((nb, nx, nx), generator=g, device=device)
                 for _ in range(2))
        beta = torch.rand((nb, 1, 1), generator=g, device=device)
        got = psf_convolve_h_cg(pp, r, beta, hr, hi)
        ref = psf_convolve_h_cg_plain(pp, r, beta, hr, hi)
        # p_prev, r read, p and conv written; the axpy and two dots
        work = conv_work(nb, nx, nx, 2 * nx, 2 * nx, hr.numel(),
                         hi is not None, extra=2)
        work = (work[0], work[1] + 6.0 * nb * nx * nx)
        for i, part in ((1, "conv"), (0, "p"), (2, "pap")):
            recs.append(_record(
                f"K2 psf_convolve_h_cg {tag}, {part}", pp.shape, got[i],
                ref[i], lambda: psf_convolve_h_cg(pp, r, beta, hr, hi),
                lambda: psf_convolve_h_cg_plain(pp, r, beta, hr, hi),
                timing and i == 1, work=work))
        # the column route K1 takes at this NX (K2 asks the same), and on
        # the card K2's conv bitwise K1 of K2's own p, reruns bitwise and
        # the stages alone
        NX = 2 * nx
        info = dict(columns=(f"cluster C={cluster_shape(NX)[0]}"
                             if cols_route(NX, nx) else "line"),
                    rows="K10br" if rows_route(NX) else "psf_rows_kernel")
        if device.type == "cuda":
            info["conv_bitwise_k1_of_p"] = bool(torch.equal(
                got[1], psf_convolve_h(got[0], hr, hi)))
            again = psf_convolve_h_cg(pp, r, beta, hr, hi)
            info["reruns_bitwise"] = all(torch.equal(a, b)
                                         for a, b in zip(got, again))
            if timing:
                bufs = psf_cg_stages(pp, r, beta, hr, hi)
                info["stage_ms"] = {
                    name: cuda_ms(lambda s=s: psf_cg_stages(
                        pp, r, beta, hr, hi, s, bufs))
                    for name, s in (("1 columns", 1), ("2 rows", 2),
                                    ("3 columns and sums", 4))}
        k2_info[tag] = info

    if pcg is None:
        cg_records(f"({nb}, {nx}^2) grid PSF", conv.consts["hr"],
                   conv.consts["hi"], nb, nx, timing)
        return err, recs, None, None, k2_info
    # bench.py's case first: its records carry the path's times
    n, nbp = pcg["nx"], pcg["nband"]
    psf_b = torch.zeros((nbp, 2 * n, 2 * n), device=device)
    psf_b[:, n, n] = 0.5
    hess = make_psf_convolve_pallas(psf_b, n, n, real_transfer=False)
    del psf_b
    hr, hi = hess.consts["hr"], hess.consts["hi"]
    cg_records(f"({nbp}, {n}^2) bench delta PSF, complex-H", hr, hi, nbp,
               n, timing)
    xr = torch.randn((nbp, n, n), generator=g, device=device)
    recs.append(_record(
        f"K1 psf_convolve_h ({nbp}, {n}^2) bench delta PSF, complex-H",
        xr.shape, psf_convolve_h(xr, hr, hi),
        psf_convolve_h_plain(xr, hr, hi), lambda: psf_convolve_h(xr, hr, hi),
        lambda: psf_convolve_h_plain(xr, hr, hi), timing,
        work=conv_work(nbp, n, n, 2 * n, 2 * n, hr.numel(), True)))
    del xr
    cg_records(f"({nb}, {nx}^2) grid PSF", conv.consts["hr"],
               conv.consts["hi"], nb, nx, False)
    del conv
    if device.type == "cuda":
        torch.cuda.empty_cache()

    x = torch.full((nbp, n, n), 1e-3, device=device)
    b = hess(x)
    niter = pcg["niter"]
    cnt = counters()
    for fn in cnt.values():
        fn.launches = 0
    fused = make_pcg_bands_fused(hess.apply, tol=0.0, maxit=niter,
                                 minit=niter, backtrack=False,
                                 apply_cg=hess.apply_cg,
                                 cg_scale=hess.cg_scale)
    rates = {
        "cg-fused (K2)": pcg_rate(
            lambda: fused(b, torch.zeros_like(b), hess.consts), niter,
            device),
        "pcg_bands (K1)": pcg_rate(
            lambda: pcg_bands(hess, b, x0=torch.zeros_like(b), tol=0.0,
                              maxit=niter, backtrack=False), niter, device),
        "pcg_bands_hostloop (K1)": pcg_rate(
            lambda: pcg_bands_hostloop(hess, b, x0=torch.zeros_like(b),
                                       tol=0.0, maxit=niter, minit=niter),
            niter, device)}
    launches = {k: fn.launches for k, fn in cnt.items()}
    return err, recs, rates, launches, k2_info


def k10_checks(psf, nx, nspace, device, timing=True, nbl=None):
    """K10's three stages against their plain versions at the shapes a
    space mesh gives them: the ``nbl``-band rows (default nb / 2, those
    of a (2, nspace) mesh), nx / nspace columns or (nx + 1 padded) /
    nspace spectrum rows per shard, with the grid phase's PSF; returns
    the records."""
    import torch

    from pfb_tpu_torch.ops.psf import (prep_h_space, psf_stage_cols_fwd,
                                       psf_stage_cols_fwd_plain,
                                       psf_stage_cols_inv,
                                       psf_stage_cols_inv_plain,
                                       psf_stage_rows, psf_stage_rows_plain,
                                       space_rows)
    nbl = psf.shape[0] // 2 if nbl is None else nbl
    psf_t = torch.as_tensor(psf[:nbl], dtype=torch.float32, device=device)
    hr, hi = prep_h_space(psf_t, nx, nx, nspace, torch.float32)
    del psf_t
    NX = NY = 2 * nx
    rows = space_rows(nx, nspace)
    nyl, rl, nxh = nx // nspace, rows // nspace, nx + 1
    hs = [h[:, :rl].contiguous() for h in (hr, hi) if h is not None]
    del hr, hi
    g = torch.Generator(device=device).manual_seed(15)
    recs = []
    x = torch.randn((nbl, nx, nyl), generator=g, device=device)
    recs.append(_record(
        f"K10a psf_stage_cols_fwd ({nbl}, {nx}, {nyl}) -> {rows} rows",
        x.shape, torch.cat(psf_stage_cols_fwd(x, NX, rows)),
        torch.cat(psf_stage_cols_fwd_plain(x, NX, rows)),
        lambda: psf_stage_cols_fwd(x, NX, rows),
        lambda: psf_stage_cols_fwd_plain(x, NX, rows), timing,
        work=(4 * (x.numel() + 2 * nbl * rows * nyl),
              nbl * fft_flops(NX, nyl, real=True)),
        flib=lambda: torch.fft.rfft(x, n=NX, dim=-2)))
    zr, zi = (torch.randn((nbl, rl, nx), generator=g, device=device)
              for _ in range(2))
    hi_ = hs[1] if len(hs) > 1 else None
    recs.append(_record(
        f"K10b psf_stage_rows ({nbl}, {rl}, {nx}), "
        f"{'complex' if hi_ is not None else 'real'}-H", zr.shape,
        torch.cat(psf_stage_rows(zr, zi, hs[0], hi_)),
        torch.cat(psf_stage_rows_plain(zr, zi, hs[0], hi_)),
        lambda: psf_stage_rows(zr, zi, hs[0], hi_),
        lambda: psf_stage_rows_plain(zr, zi, hs[0], hi_), timing,
        work=(4 * (4 * zr.numel() + sum(h.numel() for h in hs)),
              fft_flops(NY, 2 * nbl * rl) + nbl * rl * NY *
              (6 if hi_ is not None else 2))))
    del zr, zi, hs
    wr, wi = (torch.randn((nbl, rows, nyl), generator=g, device=device)
              for _ in range(2))
    wc = torch.complex(wr[:, :nxh], wi[:, :nxh])
    wc[:, 0].imag.zero_()
    wc[:, nxh - 1].imag.zero_()
    recs.append(_record(
        f"K10c psf_stage_cols_inv ({nbl}, {rows}, {nyl}) -> {nx} rows",
        (nbl, rows, nyl), psf_stage_cols_inv(wr, wi, nx, NX, NY),
        psf_stage_cols_inv_plain(wr, wi, nx, NX, NY),
        lambda: psf_stage_cols_inv(wr, wi, nx, NX, NY),
        lambda: psf_stage_cols_inv_plain(wr, wi, nx, NX, NY), timing,
        work=(4 * (2 * nbl * nxh * nyl + nbl * nx * nyl),
              nbl * fft_flops(NX, nyl, real=True)),
        flib=lambda: torch.fft.irfft(wc, n=NX, dim=-2)[..., :nx, :]))
    return recs


def space_matvec_check(psf, nx, nspace, device, timing=True):
    """hessian_psf_space_dist(method="pallas") on a (2, nspace) virtual
    mesh of the card against K1 on the whole cube, with the grid phase's
    PSF: (max|diff| / max, bitwise equal, ms of each)."""
    import torch

    from pfb_tpu_torch.ops.psf import prep_h_space, psf_convolve_h
    from pfb_tpu_torch.parallel.dist import hessian_psf_space_dist
    from pfb_tpu_torch.parallel.mesh import make_mesh
    nb = psf.shape[0]
    psf_t = torch.as_tensor(psf, dtype=torch.float32, device=device)
    hr, hi = prep_h_space(psf_t, nx, nx, nspace, torch.float32)
    del psf_t
    hs = (hr,) if hi is None else (hr, hi)
    h1 = [h[:, :nx + 1].contiguous() for h in hs]
    mesh = make_mesh(nband=2, nspace=nspace, devices=[device] * 2 * nspace)
    f = hessian_psf_space_dist(mesh, method="pallas")
    g = torch.Generator(device=device).manual_seed(16)
    x = torch.randn((nb, nx, nx), generator=g, device=device)
    # the operands laid out once, as the solvers hold them
    from pfb_tpu_torch.parallel.mesh import shard
    xs = shard(x, mesh, ("band", "space", None))
    hss = [shard(h, mesh, ("band", "space", None)) for h in hs]
    out = f(xs, *hss).gather()
    ref = psf_convolve_h(x, *h1)
    err = float((out - ref).abs().max() / ref.abs().max())
    r = dict(rel_err=err, bitwise=bool(torch.equal(out, ref)),
             complex_h=hi is not None)
    if timing:
        r["space_ms"] = cuda_ms(lambda: f(xs, *hss))
        r["k1_ms"] = cuda_ms(lambda: psf_convolve_h(x, *h1))
    return r


def dist_path(dds, hessnorm, device, nspace=4, spot=SPOT_PG):
    """_spotless_dist on a (2, nspace) virtual mesh of ``device`` on
    copies of the pg path's dds (init and grid reused), the pg path's
    hessnorm; every kernel's launches counted over the run (counts set
    to 0 just before and read just after)."""
    import torch

    from pfb_tpu_torch.parallel.mesh import make_mesh
    from pfb_tpu_torch.workers.spotless import _spotless_dist
    cnt = counters()
    for fn in cnt.values():
        fn.launches = 0
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    mesh = make_mesh(nband=2, nspace=nspace, devices=[device] * 2 * nspace)
    stats = {}
    t0 = time.perf_counter()
    model, residual = _spotless_dist(
        mesh=mesh, ddsi=[dict(ds) for ds in dds], write=False, stats=stats,
        verbose=0, hessnorm=hessnorm, **spot)
    sync(device)
    res = dict(t={"spotless_dist": time.perf_counter() - t0},
               launches={"spotless_dist": {k: fn.launches
                                           for k, fn in cnt.items()}},
               stats=stats, model=model, residual=residual, dds=dds)
    if device.type == "cuda":
        res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    return res


def rowdist_check(rpg, nx, epsilon, device, nshard=4):
    """make_vis2dirty_rowdist on a (1, nshard) virtual mesh (K4 and K5 per
    row shard, one sum of the grids) against the pg path's one-device
    dirty image of dataset 0: (max|diff| / max, seconds, launches)."""
    import numpy as np

    from pfb_tpu_torch.parallel.dist import make_vis2dirty_rowdist
    from pfb_tpu_torch.parallel.mesh import make_mesh
    ds, xds0 = rpg["dds"][0], rpg["xds"][0]
    cnt = counters()
    for fn in cnt.values():
        fn.launches = 0
    mesh = make_mesh(nband=1, nspace=nshard, devices=[device] * nshard)
    c = float(ds["cell_rad"])
    t0 = time.perf_counter()
    run, _ = make_vis2dirty_rowdist(mesh, ds["UVW"], ds["FREQ"], nx=nx,
                                    ny=nx, cellx=c, celly=c,
                                    epsilon=epsilon)
    vis = np.asarray(xds0["VIS"])
    img = run(vis.real, vis.imag, ds["WEIGHT"] * ds["MASK"])
    sync(device)
    dt = time.perf_counter() - t0
    ref = ds["DIRTY"]
    err = float(np.abs(img.cpu().numpy() - ref).max() / np.abs(ref).max())
    return err, dt, {k: fn.launches for k, fn in cnt.items()}


def blocked_dist_check(rpg, nx, device):
    """make_hessian_dds_dist(plane_block=4) (K7-K9) against
    make_hessian_dds_dist with all planes (K4-K6) on a (2, 1) virtual
    mesh, the klean path's epsilon, on the pg path's model: (max|diff| /
    max, launches of the blocked and of the all-planes matvec)."""
    import torch

    from pfb_tpu_torch.parallel.dist import make_hessian_dds_dist
    from pfb_tpu_torch.parallel.mesh import make_mesh
    dds = rpg["dds"]
    nband = len(dds)
    wsum = float(sum(float(ds["WSUM"][0]) for ds in dds))
    mesh = make_mesh(nband=2, nspace=1, devices=[device] * 2)
    x = torch.as_tensor(rpg["model"], dtype=torch.float32, device=device)
    cnt = counters()
    out, launches = {}, {}
    for label, pb in (("blocked", KLEAN["plane_block"]), ("all", None)):
        for fn in cnt.values():
            fn.launches = 0
        h = make_hessian_dds_dist(mesh, dds, nband, wsum, nx, nx,
                                  use_beam=False, backend="pg",
                                  epsilon=KLEAN["epsilon"], plane_block=pb)
        out[label] = h(x).gather()
        sync(device)
        launches[label] = {k: fn.launches for k, fn in cnt.items()}
        del h
        torch.cuda.empty_cache()
    err = float((out["blocked"] - out["all"]).abs().max()
                / out["all"].abs().max())
    return err, launches


def single_band_checks(device, n=PCG["nx"], timing=True):
    """Phase 20: K12, K13 and K14 at one band of n^2 in (2n)^2, on band 0
    of phase 14's bench PSF (a delta 0.5 at the centre) and on a random
    PSF from a fixed seed, with every kernel's launches counted over the
    entry points' run alone (counts set to 0 just before it and read
    just after); then each against its plain version, and K12, K13 and
    K14 against each other on each PSF. Returns (records, cross errors,
    launches)."""
    import torch

    from pfb_tpu_torch.ops import pallas_fft as pf
    from pfb_tpu_torch.ops.psf import prep_h, prep_h_full
    NX = 2 * n
    g = torch.Generator(device=device).manual_seed(20)
    x = torch.randn((n, n), generator=g, device=device)
    delta = torch.zeros((1, NX, NX), device=device)
    delta[0, n, n] = 0.5
    psfs = {"bench delta PSF": delta,
            "random PSF": torch.randn((1, NX, NX), generator=g,
                                      device=device)}
    calls = []  # (name, entry, plain, H operands, PSF label)
    for label, psf in psfs.items():
        for rt in ((False, True) if label == "bench delta PSF" else
                   (False,)):
            hr, hi = prep_h(psf, n, n, torch.float32, real_transfer=rt)
            h = (hr[0], None if hi is None else hi[0])
            calls.append((f"K12 psf_convolve_pallas_v3 {label}, "
                          f"{'real' if rt else 'complex'}-H",
                          pf.psf_convolve_pallas_v3,
                          pf.psf_convolve_pallas_v3_plain, h, label))
        Hr, Hi = prep_h_full(psf, torch.float32)
        for k, fn, plain in (("K13", pf.psf_convolve_pallas_v2,
                              pf.psf_convolve_pallas_v2_plain),
                             ("K14", pf.psf_convolve_pallas_opt,
                              pf.psf_convolve_pallas_opt_plain)):
            calls.append((f"{k} {fn.__name__} {label}, full complex-H", fn,
                          plain, (Hr[0], Hi[0]), label))
    del psfs, delta

    cnt = counters()
    for fn in cnt.values():
        fn.launches = 0
    outs = [fn(x, *h, n, n) for _, fn, _, h, _ in calls]
    sync(device)
    launches = {k: fn.launches for k, fn in cnt.items()}

    recs = []
    for (name, fn, plain, h, _), out in zip(calls, outs):
        recs.append(_record(
            name, x.shape, out, plain(x, *h), lambda: fn(x, *h, n, n),
            lambda: plain(x, *h), timing,
            work=conv_work(1, n, n, NX, NX, h[0].numel(), h[1] is not None)))
    cross = {}
    for label in ("bench delta PSF", "random PSF"):
        got = [(name, out) for (name, *_, lab), out in zip(calls, outs)
               if lab == label]
        ref = got[-1][1]  # K14's
        for name, out in got[:-1]:
            cross[f"{name} vs K14"] = float(
                (out - ref).abs().max() / ref.abs().max())
    cross["K12 vs 0.5 x, bench delta PSF"] = float(
        (outs[0] - 0.5 * x).abs().max() / (0.5 * x).abs().max())
    return recs, cross, launches


def k15_checks(device, nb=PCG["nband"], n=PCG["nx"], timing=True):
    """Phase 21: K15's forward then inverse on an (nb, n, n) cube, with
    every kernel's launches counted over that run alone, the round trip
    against x; then each against its plain version (the inverse on the
    forward's spectrum and on a random non-Hermitian one), with the
    library column calls. Returns (records, round-trip error,
    launches)."""
    import torch

    from pfb_tpu_torch.ops import pallas_fft as pf
    NX = 2 * n
    NXH = pf.v3_rows(NX)
    g = torch.Generator(device=device).manual_seed(21)
    x = torch.randn((nb, n, n), generator=g, device=device)
    cnt = counters()
    for fn in cnt.values():
        fn.launches = 0
    zr, zi = pf.v3_cols_fwd(x, n)
    back = pf.v3_cols_inv(zr, zi, n)
    sync(device)
    launches = {k: fn.launches for k, fn in cnt.items()}
    rt_err = float((back - x).abs().max() / x.abs().max())

    # x read and NXH spectrum rows written (the inverse the other way); a
    # real line of length NX for each column
    fwd_work = (4 * (x.numel() + 2 * nb * NXH * n),
                nb * fft_flops(NX, n, real=True))
    recs = [_record(
        f"K15a v3_cols_fwd ({nb}, {n}, {n}) -> {NXH} rows", x.shape,
        torch.cat((zr, zi)), torch.cat(pf.v3_cols_fwd_plain(x, n)),
        lambda: pf.v3_cols_fwd(x, n), lambda: pf.v3_cols_fwd_plain(x, n),
        timing, work=fwd_work,
        flib=lambda: torch.fft.fft(x, n=NX, dim=-2)[:, :NXH])]
    del back
    for label in ("forward spectrum", "random non-Hermitian spectrum"):
        if label.startswith("random"):
            del zr, zi
            zr, zi = (torch.randn((nb, NXH, n), generator=g, device=device)
                      for _ in range(2))
        wc = torch.complex(zr[:, :NX // 2 + 1], zi[:, :NX // 2 + 1])
        recs.append(_record(
            f"K15b v3_cols_inv ({nb}, {NXH}, {n}) -> {n} rows, {label}",
            zr.shape, pf.v3_cols_inv(zr, zi, n),
            pf.v3_cols_inv_plain(zr, zi, n),
            lambda: pf.v3_cols_inv(zr, zi, n),
            lambda: pf.v3_cols_inv_plain(zr, zi, n), timing, work=fwd_work,
            flib=lambda: torch.fft.irfft(wc, n=NX, dim=-2)[:, :n]))
        del wc
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return recs, rt_err, launches


# (label, nb, nx, NX, L, rows, keep) of phase 24: the shapes the paths give
# the cluster column kernels (keep None: NX/2 + 1)
COLS_SHAPES = [("K1, 2048^2", 8, 2048, 4096, 2048, 2049, None),
               ("K1 and K12, 4096^2", 8, 4096, 8192, 4096, 4097, None),
               ("K10 shard of the (2, 4) mesh", 4, 2048, 4096, 512, 2052,
                None),
               ("K11, 3072^2 in 6144^2", 8, 3072, 6144, 3072, 3073, None),
               ("K15, NXH rows", 8, 4096, 8192, 4096, 4224, 4224),
               ("K1 and K2, 1024^2", 8, 1024, 2048, 1024, 1025, None),
               ("K11, 1280^2 in 2560^2", 8, 1280, 2560, 1280, 1281, None),
               ("K11, 1536^2 in 3072^2", 8, 1536, 3072, 1536, 1537, None)]


def cols_checks(device, shapes=COLS_SHAPES, timing=True, line=False):
    """Phase 24: the cluster column kernels (psf_cols_fwd, psf_cols_inv)
    against the functions' plain versions (psf_stage_cols_fwd_plain /
    _inv_plain: rfft / irfft, or fft / ifft with the mirror at keep =
    NXH) on seeded random inputs at each shape, with the library column
    calls and (``line``, keep NX/2 + 1) line_fft_kernel's column stages
    on the same inputs (psf_line_lab). Returns the records."""
    import torch

    from pfb_tpu_torch.ops.psf import (psf_cols_fwd, psf_cols_inv,
                                       psf_line_lab,
                                       psf_stage_cols_fwd_plain,
                                       psf_stage_cols_inv_plain)
    g = torch.Generator(device=device).manual_seed(24)
    recs = []
    for label, nb, nx, NX, L, rows, keep in shapes:
        k = keep or NX // 2 + 1
        x = torch.randn((nb, nx, L), generator=g, device=device)
        # x read, rows written (re and im); a real line of NX a column
        work = (4 * (x.numel() + 2 * nb * rows * L),
                nb * fft_flops(NX, L, real=True))
        if keep is None:
            def flib():
                return torch.fft.rfft(x, n=NX, dim=-2)
        else:
            def flib():
                return torch.fft.fft(x, n=NX, dim=-2)[:, :k]
        recs.append(_record(
            f"K10ac psf_cols_fwd ({nb}, {nx}, {L}) -> {rows} rows of {NX} "
            f"({label})", x.shape,
            torch.cat(psf_cols_fwd(x, NX, rows, keep)),
            torch.cat(psf_stage_cols_fwd_plain(x, NX, rows, keep)),
            lambda: psf_cols_fwd(x, NX, rows, keep),
            lambda: psf_stage_cols_fwd_plain(x, NX, rows, keep), timing,
            work=work, flib=flib,
            fline=(lambda: psf_line_lab(1, x, NX=NX, rows=rows))
            if line else None))
        del x
        wr, wi = (torch.randn((nb, rows, L), generator=g, device=device)
                  for _ in range(2))
        wc = torch.complex(wr[:, :NX // 2 + 1], wi[:, :NX // 2 + 1])
        if keep is None:
            wc[:, 0].imag.zero_()
            wc[:, NX // 2].imag.zero_()
        s = 1.0 / NX
        recs.append(_record(
            f"K10cc psf_cols_inv ({nb}, {rows}, {L}) -> {nx} rows of {NX}"
            f" ({label}{', non-Hermitian' if keep else ''})", wr.shape,
            psf_cols_inv(wr, wi, nx, NX, keep, scale=s),
            psf_stage_cols_inv_plain(wr, wi, nx, NX, 1, keep),
            lambda: psf_cols_inv(wr, wi, nx, NX, keep, scale=s),
            lambda: psf_stage_cols_inv_plain(wr, wi, nx, NX, 1, keep),
            timing, work=(4 * (2 * nb * k * L + nb * nx * L),
                          nb * fft_flops(NX, L, real=True)),
            flib=lambda: torch.fft.irfft(wc, n=NX, dim=-2)[:, :nx],
            fline=(lambda: psf_line_lab(3, wr, wi, NX=NX, nx=nx, NY=1))
            if line else None))
        del wr, wi, wc
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return recs


# (label, nb, rows, ny, NY, H) of phase 25: the shapes the paths give the
# rows stage's register kernel (H "real", "complex", or "full": the full
# (nb, NY, NY) transfer function, K11's, with rows = NY/2 + 1)
ROWS_SHAPES = [("K1, 2048^2", 8, 2049, 2048, 4096, "complex"),
               ("K1, 2048^2", 8, 2049, 2048, 4096, "real"),
               ("K1, K2 and K12, 4096^2", 8, 4097, 4096, 8192, "complex"),
               ("K10 shard of the (2, 4) mesh", 4, 513, 2048, 4096,
                "complex"),
               ("K11, 3072^2 in 6144^2", 8, 3073, 3072, 6144, "full"),
               ("K13 and K14, one band of 4096^2", 1, 4097, 4096, 8192,
                "full"),
               ("K1 and K2, 1024^2", 8, 1025, 1024, 2048, "complex"),
               ("K11, 1280^2 in 2560^2", 8, 1281, 1280, 2560, "full"),
               ("K11, 1536^2 in 3072^2", 8, 1537, 1536, 3072, "full"),
               ("K11, 3072^2 in 4608^2", 2, 2305, 3072, 4608, "full"),
               ("K11, 2560^2 in 5120^2", 2, 2561, 2560, 5120, "full")]


def rows_work(nb, rows, ny, NY, h):
    """(bytes, operations) of a rows stage: z read and w written (re and
    im), H read once (a row of NY, re and im for a complex H, two rows
    for the full H); a forward and an inverse line of NY and the product
    with H a row."""
    R = nb * rows
    nh = {"real": 1, "complex": 2, "full": 4}[h]
    return (4.0 * R * (4 * ny + nh * NY),
            fft_flops(NY, 2 * R) + R * NY * (2 if h == "real" else 6))


def rows_checks(device, shapes=ROWS_SHAPES, l1=(8, 4224, 4096, 8192),
                timing=True, line=False):
    """Phase 25: the rows stage's register kernel K10br (psf_rows) at the
    shapes the paths give it, on seeded random rows and H, against the
    plain stage (psf_stage_rows_plain; the full H through its Hermitian
    part), printing beside each the rows stage as three torch.fft calls
    (fft, the product, ifft; for context, not a one-call library); then
    the L1 lab's rows stage on K15's NXH rows through K10's entry
    (psf_stage_rows at (8, 4224, 4096) in 8192^2; ``l1`` None: not run),
    its launches counted over its run alone. ``line``: psf_rows_kernel on
    the same rows beside each (psf_line_lab; not for the full H).
    Returns (records, three-call times, L1's launches)."""
    import torch

    from pfb_tpu_torch.ops.psf import (full_h_rows, psf_line_lab, psf_rows,
                                       psf_stage_rows, psf_stage_rows_plain)
    g = torch.Generator(device=device).manual_seed(25)
    recs, three = [], {}
    for label, nb, rows, ny, NY, h in shapes:
        zr, zi = (torch.randn((nb, rows, ny), generator=g, device=device)
                  for _ in range(2))
        hshape = (nb, NY, NY) if h == "full" else (nb, rows, NY)
        hr = torch.randn(hshape, generator=g, device=device)
        hi = None if h == "real" else torch.randn(hshape, generator=g,
                                                  device=device)
        NX = NY if h == "full" else None
        hh = full_h_rows(hr, hi) if h == "full" else (hr, hi)
        name = (f"K10br psf_rows ({nb}, {rows}, {ny}) of {NY}, {h} H "
                f"({label})")
        recs.append(_record(
            name, zr.shape, torch.cat(psf_rows(zr, zi, hr, hi, NX)),
            torch.cat(psf_stage_rows_plain(zr, zi, *hh)),
            lambda: psf_rows(zr, zi, hr, hi, NX),
            lambda: psf_stage_rows_plain(zr, zi, *hh), timing,
            work=rows_work(nb, rows, ny, NY, h),
            fline=(lambda: psf_line_lab(2, zr, zi, NX=NY, hr=hr, hi=hi))
            if line and h != "full" else None))
        if timing:
            zc = torch.complex(zr, zi)
            hc = hh[0] if hh[1] is None else torch.complex(*hh)
            three[name] = cuda_ms(lambda: torch.fft.ifft(
                torch.fft.fft(zc, n=NY, dim=-1) * hc, dim=-1)[..., :ny])
            del zc, hc
        del zr, zi, hr, hi, hh
        if device.type == "cuda":
            torch.cuda.empty_cache()

    if l1 is None:
        return recs, three, None
    # L1: wl_kernel_lab.py's rows stage on K15's NXH = 4224 rows
    nb, rows, ny, NY = l1
    zr, zi = (torch.randn((nb, rows, ny), generator=g, device=device)
              for _ in range(2))
    hr, hi = (torch.randn((nb, rows, NY), generator=g, device=device)
              for _ in range(2))
    cnt = counters()
    for fn in cnt.values():
        fn.launches = 0
    out = torch.cat(psf_stage_rows(zr, zi, hr, hi))
    sync(device)
    launches = {k: fn.launches for k, fn in cnt.items()}
    recs.append(_record(
        f"L1 psf_stage_rows ({nb}, {rows}, {ny}) of {NY}, complex H "
        "(NXH rows)", zr.shape, out,
        torch.cat(psf_stage_rows_plain(zr, zi, hr, hi)),
        lambda: psf_stage_rows(zr, zi, hr, hi),
        lambda: psf_stage_rows_plain(zr, zi, hr, hi), timing,
        work=rows_work(nb, rows, ny, NY, "complex")))
    return recs, three, launches


def rows_stages(lc):
    """Rows stages launched in a run with launches ``lc``: one for each
    call of an entry that has one (K1, K2, K10 stage 2, K11-K14)."""
    return sum(lc[k] for k in ("K1", "K2", "K10b", "K11", "K12", "K13",
                               "K14"))


def l2_checks(device, P=4, N=8192, timing=True):
    """Phase 22: the x-pass lab's kernels on a (P, N^2) re/im stack, the
    lab's other case, K3's x pass of (9, (N/4)^2) through fftx_c2c (the
    cluster route, K3c, at N/4 = 2048), and the line kernel (K3) on the y
    pass of (9, 3000^2) through fftx_c2c, where its route still runs, with
    every kernel's launches counted over their run alone (counts set to
    0 just before and read just after), then each against its plain
    version. Returns (records, split error against float64, launches)."""
    import torch

    from pfb_tpu_torch.ops import memlab
    from pfb_tpu_torch.ops.cfft import (_factor, _rolled_index, fftx_c2c,
                                        fftx_c2c_first_pass_plain,
                                        fftx_c2c_lab, fftx_c2c_plain,
                                        fftx_c2c_split, fftx_c2c_split_plain)
    g = torch.Generator(device=device).manual_seed(22)
    xr = torch.randn((P, N, N), generator=g, device=device)
    xi = torch.randn((P, N, N), generator=g, device=device)
    kw = dict(N=N, inverse=True, out_rolled=True)
    n9 = N // 4
    x9r = torch.randn((9, n9, n9), generator=g, device=device)
    x9i = torch.randn((9, n9, n9), generator=g, device=device)
    kw9 = dict(N=n9, inverse=True, out_rolled=True)
    n3 = 3000
    y3r = torch.randn((9 * n3 // 2, n3, 1), generator=g, device=device)
    y3i = torch.randn((9 * n3 // 2, n3, 1), generator=g, device=device)
    kw3 = dict(N=n3, inverse=True, out_rolled=True)
    copies = [("strip", None, False), ("strip", None, True),
              ("rows", 64, False), ("relayout", 128, False),
              ("batched", None, False)]
    cnt = counters()
    for fn in cnt.values():
        fn.launches = 0
    outs = [memlab.lab_copy(m, xr, xi if two else None, S=S)
            for m, S, two in copies]
    split = fftx_c2c_split(xr, xi, **kw)
    lab = fftx_c2c_lab(xr, xi, S=2, **kw)
    first = fftx_c2c_lab(xr, xi, npass=1, **kw)
    x9 = torch.cat(fftx_c2c(x9r, x9i, **kw9))
    y3 = torch.cat(fftx_c2c(y3r, y3i, **kw3))
    sync(device)
    launches = {k: fn.launches for k, fn in cnt.items()}

    recs = [_record(f"K3c x pass inverse out_rolled (9, {n9}^2) (L2 lab, "
                    "through fftx_c2c)", x9r.shape, x9,
                    torch.cat(fftx_c2c_plain(x9r, x9i, **kw9)), None, None,
                    False),
            _record(f"K3 y pass inverse out_rolled (9, {n3}^2) (L2 lab, "
                    "line_fft_kernel)", y3r.shape, y3,
                    torch.cat(fftx_c2c_plain(y3r, y3i, **kw3)), None, None,
                    False)]
    del x9, x9r, x9i, y3, y3r, y3i
    H = N // 2
    copy_work = (4.0 * P * N * N * 1.5, 0.0)
    for (mode, S, two), out in zip(copies, outs):
        ref = memlab.lab_copy_plain(mode, xr, xi if two else None)
        got = torch.cat([o for o in out if o is not None])
        want = torch.cat([o for o in ref if o is not None])
        sl = (slice(None), slice(0, H)) if mode in ("strip", "batched") \
            else (slice(None), slice(None), slice(0, H))
        r = _record(
            f"L2a lab_copy {mode} S={S or memlab.default_S(mode, N)}"
            f"{' re+im (k_skel)' if two else ''}", xr.shape, got, want,
            lambda m=mode, S=S, t=two: memlab.lab_copy(m, xr,
                                                       xi if t else None,
                                                       S=S),
            lambda m=mode, t=two: memlab.lab_copy_plain(m, xr,
                                                        xi if t else None),
            timing, work=tuple(w * (2 if two else 1) for w in copy_work),
            flib=lambda sl=sl: xr[sl].clone(), tol=0.0)
        r["ok"] = r["ok"] and bool(torch.equal(got, want))
        recs.append(r)
        del got, want, ref
    del outs

    N1, N2 = _factor(N)
    tc = 9 * 2.0 * P * (N2 * N1 * N1 * N + (N2 // 2) * N2 * N1 * N)
    xbytes = 8.0 * P * N * (N + H)
    z = torch.complex(xr, xi)
    recs.append(_record(
        f"L2b fftx_c2c_split ({P}, {N}^2) inverse out_rolled",
        xr.shape, torch.cat(split), torch.cat(fftx_c2c_split_plain(xr, xi,
                                                                   **kw)),
        lambda: fftx_c2c_split(xr, xi, **kw),
        lambda: fftx_c2c_split_plain(xr, xi, **kw), timing,
        work=(xbytes, 0.0, tc), flib=lambda: torch.fft.ifft(z, dim=-2)))
    # the split pass against a float64 transform, one plane at a time
    rows = _rolled_index(N, device)
    num = den = 0.0
    for p in range(P):
        ref = (torch.fft.ifft(torch.complex(xr[p].double(), xi[p].double()),
                              dim=0) * N)[rows]
        num = max(num, float((split[0][p] - ref.real).abs().max()),
                  float((split[1][p] - ref.imag).abs().max()))
        den = max(den, float(ref.abs().max()))
        del ref
    del split
    xw = (xbytes, P * fft_flops(N, N))
    recs.append(_record(
        f"L2c fftx_c2c_lab S=2 ({P}, {N}^2)", xr.shape, torch.cat(lab),
        torch.cat(fftx_c2c_plain(xr, xi, **kw)),
        lambda: fftx_c2c_lab(xr, xi, S=2, **kw),
        lambda: fftx_c2c_plain(xr, xi, **kw), timing, work=xw,
        flib=lambda: torch.fft.ifft(z, dim=-2)))
    del lab
    recs.append(_record(
        f"L2c fftx_c2c_lab npass=1 ({P}, {N}^2)", xr.shape, torch.cat(first),
        torch.cat(fftx_c2c_first_pass_plain(xr, xi, **kw)),
        lambda: fftx_c2c_lab(xr, xi, npass=1, **kw),
        lambda: fftx_c2c_first_pass_plain(xr, xi, **kw), timing,
        work=(xbytes, 0.0)))
    del first, z, xr, xi
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return recs, num / den, launches


def l3_checks(device, nrow=125_000, nchan=8, nx=1024, timing=True, reps=3):
    """Phase 23: the capacity lab's path on its observation, with every
    kernel's launches counted over it alone: _spread_fold at capacity
    128, 256 and 512 (their grids against capacity 128's), K4 through
    pack_entries at pair width 1 and 2; then the paired spreads against
    the plain spread. Returns (records, sweep, launches)."""
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent / "scripts"))
    from torch_capacity_lab import observation, packed_vis, plan

    from pfb_tpu_torch.ops import pgridder as pg
    obs = observation(nrow, nchan)
    rng = obs[3]
    vr, vi = (torch.as_tensor(rng.normal(size=(nrow, nchan)).astype(
        "float32"), device=device) for _ in range(2))
    plans = {cap: plan(obs, nx, cap, device) for cap in (128, 256, 512)}
    p = plans[128]
    k = p["k"]
    geo = dict(ntx=p["ntx"], nty=p["nty"], txs=p["txs"], tys=p["tys"], k=k)
    skw = dict(beta=p["beta"], k=k, nw=p["nw"], Thx=p["txs"] + k,
               Thy=p["tys"] + k)

    def spread_fold(q):
        return pg._spread_fold(
            vr, vi, None, q["tid"], q["pos"], q["idx"], q["pm"], q["uvw_d"],
            q["freq_d"], beta=q["beta"], k=q["k"], nw=q["nw"], ntx=q["ntx"],
            nty=q["nty"], txs=q["txs"], tys=q["tys"], C=q["C"], x0=q["x0"],
            y0=q["y0"], Nx=q["Nx"], Ny=q["Ny"])

    vis = packed_vis(p, vr, vi)
    cnt = counters()
    for fn in cnt.values():
        fn.launches = 0
    grids = {cap: spread_fold(q) for cap, q in plans.items()}
    packs = {P: pg.pack_entries(p["pos"], vis, p["tid"], p["pm"], P, **geo)
             for P in (1, 2)}
    outs = {P: pg.pg_spread(q["pos"], q["vis"], q["slots"], **skw)
            for P, q in packs.items()}
    sync(device)
    launches = {key: fn.launches for key, fn in cnt.items()}

    g0 = grids[128]
    sweep = {"capacity_rel_diff": {
        cap: float((g - g0).abs().max() / g0.abs().max())
        for cap, g in grids.items() if cap != 128}}
    del grids, g0
    for cap, q in plans.items():
        nvis = int((q["pm"] != 0).sum())
        ms = cuda_ms(lambda q=q: spread_fold(q), reps) if timing else None
        sweep[cap] = dict(entries=q["nentries"], C=q["C"], ms=ms,
                          us_per_entry=None if ms is None else
                          1e3 * ms / q["nentries"],
                          us_per_vis=None if ms is None else 1e3 * ms / nvis)
    recs = []
    for P, q in packs.items():
        live = q["slots"]["live"]
        ref = pg.pg_spread_plain(q["pos"], q["vis"], q["slots"], **skw)
        recs.append(_record(
            f"L3 pg_spread on pack_entries P={P} (capacity {P * p['C']}, "
            f"{q['pos'].shape[0]} steps)", q["pos"].shape,
            outs[P][:, :, live], ref[:, :, live],
            lambda q=q: pg.pg_spread(q["pos"], q["vis"], q["slots"], **skw),
            lambda q=q: pg.pg_spread_plain(q["pos"], q["vis"], q["slots"],
                                           **skw),
            timing, reps=reps,
            work=spread_work(q["pos"][:, 2], q["pm"] != 0, k, p["nw"],
                             int(live.sum()), skw["Thx"], skw["Thy"])))
        del ref
    del outs, packs, plans, vis
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return recs, sweep, launches


def small_kernel_checks(psf, nx, device, timing=True):
    """Phase 26's records: K1 with the 1024^2 path's PSF cube (complex
    and real H), and K3's x pass on the cluster column kernel (K3c) and
    y pass on the row kernel (K3r) at the lengths below 4096 (SMALL_PASSES),
    inverse out_rolled and forward in_rolled, each against its plain
    version."""
    import torch
    g = torch.Generator(device=device).manual_seed(26)
    recs = k1_records(psf, nx, device, g, timing)
    for P, N in SMALL_PASSES:
        for inv, pin, pout, tag in ((True, False, True, "out_rolled inverse"),
                                    (False, True, False, "in_rolled forward")):
            nin = N // 2 if pin else N
            xr = torch.randn((P, nin, nin), generator=g, device=device)
            xi = torch.randn((P, nin, nin), generator=g, device=device)
            recs.append(_xpass_record(f"K3c x pass {tag} ({P}, {N}^2)", xr,
                                      xi, N, inv, pin, pout, timing))
            del xr, xi
            recs.append(_ypass_record(f"K3r y pass {tag} ({P}, {N}^2)", P, N,
                                      inv, pin, pout, g, timing))
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return recs


def row_planes(N):
    """Planes of phase 32's y-pass records at row length N: 9 (the pg
    image plan's at 2048^2) up to 8192, 2 above (as phase 4's K3r at
    12288)."""
    return 9 if N <= 8192 else 2


def _long_rows_record(nb, NY, h, g, device, timing):
    """K10br (psf_rows) on K1's (nb, NY/2 + 1, NY/2) rows at NY with a
    complex H, or K11's with the full (nb, NY, NY) H (h "full"), against
    the plain stage (psf_stage_rows_plain) a band at a time."""
    import torch

    from pfb_tpu_torch.ops.psf import (full_h_rows, psf_rows,
                                       psf_stage_rows_plain)
    ny, rows = NY // 2, NY // 2 + 1
    zr, zi = (torch.randn((nb, rows, ny), generator=g, device=device)
              for _ in range(2))
    hshape = (nb, NY, NY) if h == "full" else (nb, rows, NY)
    hr, hi = (torch.randn(hshape, generator=g, device=device)
              for _ in range(2))
    NX = NY if h == "full" else None
    hh = full_h_rows(hr, hi) if h == "full" else (hr, hi)

    def plain():
        parts = [psf_stage_rows_plain(zr[b], zi[b], hh[0][b], hh[1][b])
                 for b in range(nb)]
        return (torch.stack([q[0] for q in parts]),
                torch.stack([q[1] for q in parts]))
    r = _record(
        f"K10br psf_rows ({nb}, {rows}, {ny}) of {NY}, {h} H (R2 = "
        f"{NY // 256})", zr.shape, torch.cat(psf_rows(zr, zi, hr, hi, NX)),
        torch.cat(plain()), lambda: psf_rows(zr, zi, hr, hi, NX), plain,
        timing, work=rows_work(nb, rows, ny, NY, h))
    del zr, zi, hr, hi, hh
    return r


def _four_records(tag, xr, xi, N, timing, chunks=4):
    """The four-step (fftx_c2c_four: K3f, then K3c at N / 8 on 8 L
    columns; fftx_c2c's route above 16384 before K3xl and K3yl, the lab's
    since) on a (P, N, L) stack, inverse out_rolled, as two records:
    K3f alone against fftx_c2c_four_first_plain (its bound its own bytes,
    8 P L (N + N) read and written, and the 8-point DFTs and twiddles;
    no library call), and the route through fftx_c2c_four against
    fftx_c2c_four_plain with torch.fft on the whole stack as the library
    call. The plain versions run in ``chunks`` pieces of columns, or of
    rows where L = 1."""
    import torch

    from pfb_tpu_torch import kernels
    from pfb_tpu_torch.ops.cfft import (fftx_c2c_cluster,
                                        fftx_c2c_four,
                                        fftx_c2c_four_first_plain,
                                        fftx_c2c_four_plain)
    kw = dict(N=N, inverse=True, out_rolled=True)
    P, _, L = xr.shape
    M = N // 8
    dev = xr.device
    dim = 0 if L == 1 else 2

    def first_plain():
        parts = [fftx_c2c_four_first_plain(a, b, N=N, inverse=True) for a, b
                 in zip(xr.chunk(chunks, dim), xi.chunk(chunks, dim))]
        return tuple(torch.cat([q[k].reshape(q[k].shape[0], M, 8, -1)
                                for q in parts], 0 if L == 1 else 3)
                     .reshape(-1, M, 8 * L) for k in (0, 1))

    if dev.type == "cuda":
        TW = kernels.twiddles(N, dev, kind="four")
        tr, ti = (torch.empty((P, M, 8 * L), device=dev) for _ in range(2))

        def k3f():
            kernels.check(kernels.library().pfbt_cfft_four(
                xr.data_ptr(), xi.data_ptr(), tr.data_ptr(), ti.data_ptr(),
                P, L, N, 0, 1, TW.data_ptr(), kernels.stream_ptr()),
                "pfbt_cfft_four")
            return tr, ti
    else:
        def k3f():
            return fftx_c2c_four_first_plain(xr, xi, N=N, inverse=True)
    out = torch.cat(k3f())
    ref = torch.cat(first_plain())
    # 8 P L N/8 radix-8 DFTs and 7 P L N/8 twiddle products (6 each)
    k3f_rec = _record(
        f"K3f alone {tag} inverse {list(xr.shape)}, N = {N} (radix 8, "
        f"twiddles, reorder to ({P}, {M}, {8 * L}))", xr.shape, out, ref,
        k3f, first_plain, timing,
        work=(8 * P * L * (N + N), fft_flops(8, P * L * M)
              + 6.0 * 7 * P * L * M))
    del out, ref
    if dev.type == "cuda":
        del tr, ti
        torch.cuda.empty_cache()

    # the CPU rehearsal's lengths are off the four-step: its plain version
    four = fftx_c2c_four if dev.type == "cuda" else fftx_c2c_four_plain
    f0, c0 = fftx_c2c_four.launches, fftx_c2c_cluster.launches
    out = torch.cat(four(xr, xi, **kw))
    need(dev.type != "cuda" or (fftx_c2c_four.launches,
                                fftx_c2c_cluster.launches) == (f0 + 1,
                                                               c0 + 1),
         f"the pass at N={N} did not take the four-step")

    def plain():
        parts = [fftx_c2c_four_plain(a, b, **kw) for a, b in
                 zip(xr.chunk(chunks, dim), xi.chunk(chunks, dim))]
        return (torch.cat([q[0] for q in parts], dim),
                torch.cat([q[1] for q in parts], dim))
    ref = torch.cat(plain())
    z = torch.complex(xr, xi)
    route_rec = _record(
        f"four-step route {tag} inverse out_rolled {list(xr.shape)}, N = "
        f"{N} (K3f, then K3c at {M})", xr.shape, out, ref,
        lambda: four(xr, xi, **kw), plain, timing,
        work=(8 * P * L * (N + N // 2), P * fft_flops(N, L)),
        flib=lambda: torch.fft.ifft(z, dim=-2))
    del out, ref, z
    return [k3f_rec, route_rec]


def _long_record(name, xr, xi, N, inv, pin, pout, timing, chunks=4):
    """K3xl (the x pass, L > 1) or K3yl (rows, L = 1) through fftx_c2c on
    a (P, Nin, L) stack against its plain version in ``chunks`` pieces of
    columns or rows, with torch.fft along dim -2 of the zero-padded (P, N,
    L) stack as the library call and the earlier route on the same inputs
    (fftx_c2c_four: K3f, then K3c at N / 8; ``old_ms``); then the lab's
    one-pass design of the same pass (K3cl for the x pass, K3fr for rows)
    as a record of its own against its plain version, with the same
    library call. Returns the two records."""
    import torch

    from pfb_tpu_torch.ops import cfft as cf
    kw = dict(N=N, inverse=inv, in_rolled=pin, out_rolled=pout)
    P, nin, L = xr.shape
    dev = xr.device
    rows = L == 1
    dim = 0 if rows else 2
    if rows:
        path, path_plain = cf.fftx_c2c_rows_long, cf.fftx_c2c_rows_long_plain
        # K3fr's steps are the four-step's
        lab, lab_plain = cf.fftx_c2c_four_rows, cf.fftx_c2c_four_plain
    else:
        path, path_plain = cf.fftx_c2c_cols_long, cf.fftx_c2c_cols_long_plain
        lab = cf.fftx_c2c_cluster_long

        def lab_plain(a, b, **k):  # the cluster kernel's at its C
            return cf.fftx_c2c_cluster_plain(a, b, C=cf._LONG_C, **k)
    z = torch.zeros((P, N, L), dtype=torch.complex64, device=dev)
    z[:, cf._rolled_index(N, dev) if pin else slice(None)] = \
        torch.complex(xr, xi)
    fft = torch.fft.ifft if inv else torch.fft.fft
    work = (8 * P * L * (nin + (N // 2 if pout else N)), P * fft_flops(N, L))
    # the CPU rehearsal's lengths are off the lab's kernels: their plain
    labfn = lab if dev.type == "cuda" else lab_plain
    recs = []
    for tag, fn, plain_fn, route in (
            (name, lambda: cf.fftx_c2c(xr, xi, **kw), path_plain, path),
            (f"{'K3cl' if not rows else 'K3fr'} lab, same pass: "
             + name.split(" ", 1)[1], lambda: labfn(xr, xi, **kw),
             lab_plain, lab)):
        n0 = route.launches
        out = torch.cat(fn())
        need(dev.type != "cuda" or route.launches == n0 + 1,
             f"{tag} did not take its kernel")

        def plain(plain_fn=plain_fn):
            parts = [plain_fn(a, b, **kw) for a, b in
                     zip(xr.chunk(chunks, dim), xi.chunk(chunks, dim))]
            return tuple(torch.cat([q[k] for q in parts], dim)
                         for k in (0, 1))
        ref = torch.cat(plain())
        recs.append(_record(tag, xr.shape, out, ref, fn, plain, timing,
                            work=work, flib=lambda: fft(z, dim=-2),
                            reps=5 if route is path else 3))
        del out, ref
    del z
    if timing:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        # the CPU rehearsal's lengths are off the four-step
        four = cf.fftx_c2c_four if dev.type == "cuda" else \
            cf.fftx_c2c_four_plain
        recs[0]["old_ms"] = cuda_ms(lambda: four(xr, xi, **kw))
    return recs


def _long_records(N, g, device, timing):
    """Phase 32's records of K3xl and K3yl at N (and of the lab's K3cl and
    K3fr beside them): the x pass of one plane and the y pass of the rows
    it leaves, inverse out_rolled ((1, N, N), then N/2 rows of N) and
    forward in_rolled ((1, N/2, N/2), then N rows of N/2), each with the
    earlier route's time."""
    import torch
    recs = []
    for inv, pin, pout, mtag in ((True, False, True, "inverse out_rolled"),
                                 (False, True, False, "forward in_rolled")):
        nin = N // 2 if pin else N
        for name, shape in (("K3xl x pass", (1, nin, nin)),
                            ("K3yl y pass", (N if pin else N // 2, nin, 1))):
            xr, xi = (torch.randn(shape, generator=g, device=device)
                      for _ in range(2))
            recs += _long_record(f"{name} {mtag} {list(shape)}, N = {N}",
                                 xr, xi, N, inv, pin, pout, timing)
            del xr, xi
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return recs


def long_kernel_checks(device, timing=True, lengths=NEW_ROW_LENGTHS,
                       four=FOUR_LENGTHS):
    """Phase 32's records: K3r's y pass at each of ``lengths`` (row_planes
    planes; inverse out_rolled and forward in_rolled), K10br there on
    (8, NY/2 + 1, NY/2) rows (complex H; the full H at 3840, K11's of
    the 1920^2 path), the earlier four-step at each of ``four`` on one
    plane (its x pass and the y pass of the rows that leaves; the lab's
    route since K3xl and K3yl), and K3xl and K3yl there in both modes,
    with the lab's K3cl and K3fr (_long_records)."""
    import torch
    g = torch.Generator(device=device).manual_seed(32)
    recs = []
    for N in lengths:
        P = row_planes(N)
        for inv, pin, pout, tag in ((True, False, True, "out_rolled inverse"),
                                    (False, True, False, "in_rolled forward")):
            recs.append(_ypass_record(
                f"K3r y pass {tag} ({P}, {N}^2) (R2 = {N // 256})", P, N,
                inv, pin, pout, g, timing))
            if device.type == "cuda":
                torch.cuda.empty_cache()
        for h in ("complex",) + (("full",) if N == 2 * NX_1920 else ()):
            recs.append(_long_rows_record(8, N, h, g, device, timing))
            if device.type == "cuda":
                torch.cuda.empty_cache()
    for N in four:
        for tag, shape in (("x pass", (1, N, N)), ("y pass", (N // 2, N, 1))):
            xr, xi = (torch.randn(shape, generator=g, device=device)
                      for _ in range(2))
            recs += _four_records(tag, xr, xi, N, timing)
            del xr, xi
            if device.type == "cuda":
                torch.cuda.empty_cache()
        recs += _long_records(N, g, device, timing)
    return recs


def four_step_path(workdir, device, nx=4608):
    """Phase 32 (c): _grid(backend="pg") at nx^2 on a small observation
    (8 antennas, 4 integrations, 2 channels), whose PSF grid of 4 nx above
    16384 takes the four-step in both passes, w-gridding off so that one
    plane of that grid fits, counts reset just before and read just
    after; its PSF and dirty image against the same call on the kernels'
    plain versions (plain_gridder), relative to their peaks."""
    import numpy as np
    import torch

    from pfb_tpu_torch.utils.ms import simulate_ms
    from pfb_tpu_torch.workers.grid import _grid
    from pfb_tpu_torch.workers.init import _init
    ms = str(Path(workdir) / f"small{nx}.npz")
    simulate_ms(ms, nant=8, ntime=4, nchan=2, nsource=3, fov_deg=0.4,
                seed=19)
    xds = _init(ms=ms, write=False, channels_per_image=2,
                precision="single", device=device)
    kw = dict(xdsi=xds, write=False, device=device, nx=nx, ny=nx,
              cell_size=0.5, robustness=0.0, backend="pg", epsilon=1e-5,
              do_wgridding=False, psf=True, residual=False)
    cnt = counters()
    for fn in cnt.values():
        fn.launches = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dds = _grid(**kw)
    sync(device)
    res = dict(t=time.perf_counter() - t0, nds=len(dds),
               launches={k: fn.launches for k, fn in cnt.items()},
               psf_shape=list(dds[0]["PSF"].shape))
    if device.type == "cuda":
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
    with plain_gridder():
        ref = _grid(**kw)
    res["rel_err"] = {key: max(
        float(np.abs(np.asarray(a[key], np.float64)
                     - np.asarray(b[key], np.float64)).max()
              / np.abs(np.asarray(b[key], np.float64)).max())
        for a, b in zip(dds, ref)) for key in ("PSF", "DIRTY")}
    return res


@contextlib.contextmanager
def earlier_route():
    """Inside the block fftx_c2c sends the lengths of K3xl and K3yl to the
    route they replaced, the four-step (K3f, then K3c at N / 8)."""
    from pfb_tpu_torch.ops import cfft
    route = cfft.fftx_c2c_route

    def old(N, L):
        r = route(N, L)
        if r in ("cols_long", "rows_long") and cfft.four_step_fits(N, L):
            return "four"
        return r
    cfft.fftx_c2c_route = old
    try:
        yield
    finally:
        cfft.fftx_c2c_route = route


def wgrid_psf_path(workdir, device, nx=NX_W, sim=SIM_W):
    """Phase 34: phase 3's observation re-simulated at nx^2, its
    hour-angle span cut (SIM_W; the planes a band printed for the cut and
    the whole span), then _init ->
    _grid(backend="pg", psf=True, do_wgridding=True): a PSF grid of (2
    good_even_size(2 nx))^2, whose two passes of every w plane take K3xl
    and K3yl, counts reset just before and read just after; the grid's
    seconds and peak memory; the same call on the route K3xl and K3yl
    replaced (earlier_route: its seconds, peak memory and launches); and
    the same call on the plain versions (plain_gridder, one plane a
    transform), its PSF and dirty image against this call's, relative to
    their peaks."""
    import numpy as np
    import torch

    from pfb_tpu_torch.ops.fft import good_even_size
    from pfb_tpu_torch.ops.pgridder import kernel_params, w_geometry
    from pfb_tpu_torch.utils.simulation import simulate_obs
    from pfb_tpu_torch.workers.grid import _grid
    from pfb_tpu_torch.workers.init import _init
    truth = simulate(workdir, nx=nx, sim=sim)
    res = dict(nvis=truth["nvis"], t_simulate=truth["t_simulate"])
    t0 = time.perf_counter()
    xds = _init(ms=truth["ms"], write=False, device=device, **INIT)
    res["t_init"] = time.perf_counter() - t0
    npsf = good_even_size(int(2.0 * nx))
    cell = truth["cell_rad"]
    k = kernel_params(GRID_PG["epsilon"])[0]
    res["nw"] = [w_geometry(ds["UVW"], ds["FREQ"], npsf, npsf, cell, cell,
                            0.0, 0.0, 2.0, k, True)[0] for ds in xds]
    # the same observation over its whole span (phase 3's), which the cut
    # is for: a band's planes at the same grid and cell
    full = simulate_obs(nant=sim["nant"], ntime=sim["ntime"],
                        nchan=sim["nchan"], seed=sim["seed"],
                        extent=sim["extent"])
    res["nw_full_span"] = [w_geometry(full.uvw, full.freq[c:c + 1], npsf,
                                      npsf, cell, cell, 0.0, 0.0, 2.0, k,
                                      True)[0]
                           for c in range(len(full.freq))]
    res["grid_n"] = 2 * npsf
    plane = (2 * npsf) ** 2 * 8
    print(f"[{nx}w] {truth['nvis']} visibilities, {len(xds)} bands, cell "
          f"{cell:.6e} rad, PSF {npsf}^2 on a {2 * npsf}^2 grid: w planes "
          "by band "
          f"{res['nw']}, planes' bytes by band (nw x {2 * npsf}^2 x 8 B) "
          + json.dumps([nw * plane for nw in res["nw"]]) + f" = "
          f"{[round(nw * plane / 2**30, 2) for nw in res['nw']]} GiB; over "
          f"phase 3's whole span {res['nw_full_span']} planes = "
          f"{[round(nw * plane / 1e9, 1) for nw in res['nw_full_span']]} GB")
    kw = dict(GRID_PG, nx=nx, ny=nx, do_wgridding=True, xdsi=xds,
              write=False, device=device)
    cnt = counters()

    def run(tag):
        for fn in cnt.values():
            fn.launches = 0
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        dds = _grid(**kw)
        sync(device)
        res[f"t_grid{tag}"] = time.perf_counter() - t0
        res[f"launches{tag}"] = {k: fn.launches for k, fn in cnt.items()}
        if device.type == "cuda":
            res[f"peak_gb{tag}"] = torch.cuda.max_memory_allocated() / 2**30
        return dds

    def rel(got, want):
        return {key: max(
            float(np.abs(np.asarray(a[key], np.float64)
                         - np.asarray(b[key], np.float64)).max()
                  / np.abs(np.asarray(b[key], np.float64)).max())
            for a, b in zip(got, want)) for key in ("PSF", "DIRTY")}
    dds = run("")
    res["nds"] = len(dds)
    with earlier_route():
        old = run("_earlier")
    res["earlier_rel_err"] = rel(old, dds)
    del old
    with plain_gridder(planes=1):
        ref = run("_plain")
    res["rel_err"] = rel(dds, ref)
    del ref, dds, xds
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return res


def short_path(workdir, device, nx, sim=SIM, timing=True):
    """Phase 33 (a) and (b): phase 3's observation re-simulated at nx^2
    with the same cell, init -> grid(pg) -> spotless(pg) on the short
    designs, then, where v3 holds (spotless on K1), K2's CG-fused solve
    against pcg_bands on K1 with this path's PSF cube (k2_checks without
    the bench case). Returns the path's launches, seconds, peaks, stats,
    whether v3 holds and K2's (error, records, cases)."""
    import torch

    from pfb_tpu_torch.ops.psf import v3_supported
    from pfb_tpu_torch.workers.cubes import dds2cubes
    truth = simulate(workdir, nx=nx, sim=sim)
    print(f"[{nx}] simulate {truth['t_simulate']:.3f} s (host), cell "
          f"{truth['cell_rad']:.6e} rad, {truth['nvis']} visibilities")
    res = main_path(truth, device, grid=dict(GRID_PG, nx=nx, ny=nx),
                    spot=SPOT_PG)
    report_path(str(nx), res, truth, nx)
    out = dict(launches=res["launches"], t=res["t"],
               peak_gb=res.get("peak_gb", {}), stats=res["stats"],
               v3=v3_supported(nx, nx), cerr=None, k2_recs=[], k2_info={})
    if out["v3"]:
        cubes = dds2cubes(res["dds"], len(res["dds"]))
        k2 = k2_checks(cubes[3], cubes[6], res["model"], device, timing,
                       pcg=None)
        out.update(cerr=k2[0], k2_recs=k2[1], k2_info=k2[4])
        del cubes
    del res, truth
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def short_kernel_checks(device, timing=True, lengths=SHORT_LENGTHS, P=9):
    """Phase 33 (c): at each short length N, K3c's x pass and K3r's y
    pass of (P, N^2), inverse out_rolled and forward in_rolled, K10ac /
    K10cc at (8, N/2, N/2) of N and K10br on (8, N/2 + 1, N/2) rows of N
    with a complex H, each against its plain version, with the line
    kernel these lengths took before on the same inputs (line_ms)."""
    import torch
    g = torch.Generator(device=device).manual_seed(33)
    recs = []
    for N in lengths:
        for inv, pin, pout, tag in ((True, False, True, "out_rolled inverse"),
                                    (False, True, False, "in_rolled forward")):
            nin = N // 2 if pin else N
            xr = torch.randn((P, nin, nin), generator=g, device=device)
            xi = torch.randn((P, nin, nin), generator=g, device=device)
            recs.append(_xpass_record(f"K3c x pass {tag} ({P}, {N}^2)", xr,
                                      xi, N, inv, pin, pout, timing,
                                      line=True))
            del xr, xi
            recs.append(_ypass_record(f"K3r y pass {tag} ({P}, {N}^2)", P, N,
                                      inv, pin, pout, g, timing, line=True))
            if device.type == "cuda":
                torch.cuda.empty_cache()
    cols = [(f"K1, {N // 2}^2", 8, N // 2, N, N // 2, N // 2 + 1, None)
            for N in lengths]
    rows = [(f"K1, {N // 2}^2", 8, N // 2 + 1, N // 2, N, "complex")
            for N in lengths]
    recs += cols_checks(device, cols, timing, line=True)
    recs += rows_checks(device, rows, None, timing, line=True)[0]
    return recs


def report_klean(rkl, truth, nx):
    """Print the klean path's stage time, memory, residuals and
    launches; check its residual and image."""
    import numpy as np
    st = rkl["stats"]
    print("[klean] stage seconds " + json.dumps(
        {k: round(v, 3) for k, v in rkl["t"].items()}))
    print(f"[klean] peak device memory {rkl['peak_mem_gb']:.2f} GiB; "
          f"dirty MFS rms {rkl['dirty_rms']:.6e}")
    for k, (r, m, c) in enumerate(zip(st["rms"], st["rmax"],
                                      st["status"])):
        print(f"[klean] major {k + 1}: MFS residual rms {r:.6e}, "
              f"peak {m:.6e}, clark status {c}")
    print("[klean] launches " + json.dumps(rkl["launches"]))
    srcs = source_checks(rkl, truth)
    for s in srcs:
        print(f"[klean] source {s}")
    need(st["rms"] and all(np.isfinite(v) for v in st["rms"]) and
         np.isfinite(rkl["model"]).all(), "klean: non-finite model/residual")
    need(rkl["model"].shape == (len(rkl["dds"]), nx, nx),
         f"klean: model shape {rkl['model'].shape}")
    need(st["rms"][-1] < rkl["dirty_rms"],
         f"klean: residual rms {st['rms'][-1]} not below dirty rms "
         f"{rkl['dirty_rms']}")
    need(all(s["local_max"] for s in srcs),
         f"klean: bright sources not recovered at their pixels: {srcs}")


def mfs_over_wsum(dds, key):
    return sum(ds[key] for ds in dds) / \
        sum(float(ds["WSUM"][0]) for ds in dds)


def timed_step(res, device, name, fn):
    """Run ``fn()`` as step ``name`` of a path: every kernel's count set
    to 0 just before and read just after into res["launches"][name],
    with its host-clock seconds (ending in a synchronise) and, on the
    card, its peak device memory (max_memory_allocated after a reset)."""
    import torch
    cnt = counters()
    for c in cnt.values():
        c.launches = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    res["t"][name] = time.perf_counter() - t0
    res["launches"][name] = {k: c.launches for k, c in cnt.items()}
    if device.type == "cuda":
        res["peak_gib"][name] = torch.cuda.max_memory_allocated() / 2**30
    return out


def post_path(rkl, rpg, truth, device, workdir, grid=GRID_PG):
    """Phase 27: klean's model through model2comps -> degrid(pg) ->
    init(DATA-MODEL_DATA) -> grid, then grid(transfer_model_from),
    restore and fluxmop (single-program and on a (1, NSPACE) virtual
    space mesh) on the path's products. Every step's counts are set to 0
    just before it and read just after, with its seconds and peak device
    memory; returns them with the step's outputs the gates read."""
    import numpy as np

    from pfb_tpu_torch.models.comps import eval_coeffs_to_cube
    from pfb_tpu_torch.workers.degrid import _degrid
    from pfb_tpu_torch.workers.fluxmop import _fluxmop
    from pfb_tpu_torch.workers.grid import _grid
    from pfb_tpu_torch.workers.init import _init
    from pfb_tpu_torch.workers.model2comps import _model2comps
    from pfb_tpu_torch.workers.restore import _restore

    res = {"t": {}, "peak_gib": {}, "launches": {}}

    def step(name, fn):
        return timed_step(res, device, name, fn)

    model, nband = rkl["model"], rkl["model"].shape[0]
    nx = model.shape[-1]
    dds_m = [dict(ds, MODEL=model[ds["bandid"]]) for ds in rkl["dds"]]
    mds = step("model2comps", lambda: _model2comps(
        ddsi=dds_m, fit_mode="Legendre", nbasisf=nband))
    cube = eval_coeffs_to_cube(
        np.unique([ds["time_out"] for ds in dds_m]),
        np.unique([ds["freq_out"] for ds in dds_m]), nx, nx,
        mds["coefficients"], mds["location_x"], mds["location_y"],
        mds["parametrisation"], mds["params"], mds["texpr"],
        mds["fexpr"])[0]
    res["ncomp"], res["nband"] = int(mds["location_x"].size), nband
    res["mds"] = mds  # phase 28's model
    res["fit_err"] = float(np.max(np.abs(cube - model) / np.abs(1 + model)))
    del cube, dds_m

    res["degrid"] = {}

    def degrid():  # writes MODEL_DATA; the returned column is not kept
        _degrid(ms=truth["ms"], mds=mds, backend="pg",
                epsilon=grid["epsilon"], channels_per_image=1,
                device=device, stats=res["degrid"])
    step("degrid", degrid)

    dirty_max = float(np.abs(mfs_over_wsum(rpg["dds"], "DIRTY")).max())
    kres_mfs = rkl["residual"].sum(axis=0)
    xds2 = step("init", lambda: _init(
        ms=truth["ms"], precision="single", channels_per_image=1,
        data_column="DATA-MODEL_DATA", write=False, device=device))
    dds_r = step("grid", lambda: _grid(
        xdsi=xds2, write=False, device=device,
        **dict(grid, psf=False, residual=False)))
    res["regrid_err"] = float(np.abs(mfs_over_wsum(dds_r, "DIRTY")
                                     - kres_mfs).max() / dirty_max)
    del xds2, dds_r
    dds_t = step("transfer", lambda: _grid(
        xdsi=rpg["xds"], write=False, device=device,
        transfer_model_from=mds, **dict(grid, psf=False, residual=True)))
    res["transfer_err"] = float(np.abs(mfs_over_wsum(dds_t, "RESIDUAL")
                                       - kres_mfs).max() / dirty_max)
    del dds_t

    wsum = sum(float(ds["WSUM"][0]) for ds in rkl["dds"])
    dds_k = [dict(ds, MODEL=model[ds["bandid"]],
                  RESIDUAL=rkl["residual"][ds["bandid"]] * wsum)
             for ds in rkl["dds"]]
    base = str(Path(workdir) / "post")
    for old in Path(workdir).glob("post_I_main.*.fits"):
        old.unlink()
    out = step("restore", lambda: _restore(
        ddsi=dds_k, output_filename=base, outputs=POST_OUTPUTS))
    res["fits"] = sorted(p.name for p in
                         Path(workdir).glob("post_I_main.*.fits"))
    res["image_mfs"] = out["image_mfs"]
    del dds_k, out

    m1, r1 = step("fluxmop", lambda: _fluxmop(
        ddsi=[dict(ds) for ds in rpg["dds"]], device=device, **MOP))
    res["mop_ratio"] = float(np.abs(r1.sum(axis=0)).max() / dirty_max)
    st4 = {}
    m4, _ = step("fluxmop_space", lambda: _fluxmop(
        ddsi=[dict(ds) for ds in rpg["dds"]], device=device,
        space_shards=NSPACE, devices=[device] * NSPACE, stats=st4, **MOP))
    res["mop_space_route"] = st4["hessian"]
    res["mop_space_err"] = float(np.abs(m4 - m1).max() / np.abs(m1).max())
    return res


def report_post(rpost, truth):
    """Print phase 27's stage seconds, peak memory, launches, errors and
    degrid's host and device split; check its gates."""
    import numpy as np
    lp = rpost["launches"]
    print("[post] " + json.dumps({
        "seconds": {k: round(v, 3) for k, v in rpost["t"].items()},
        "peak_gib": {k: round(v, 3) for k, v in rpost["peak_gib"].items()},
        "launches": {s: {k: v for k, v in c.items() if v}
                     for s, c in lp.items()}}))
    dg = rpost["degrid"]
    print(f"[post] degrid, {dg['nimages']} images: rendering "
          f"{dg['render_s']:.3f} s, pg plans {dg['plan_s']:.3f} s (host), "
          f"degrids with their copies to the host {dg['degrid_s']:.3f} s, "
          f"update_ms_column {dg['write_s']:.3f} s")
    print(f"[post] mds: {rpost['ncomp']} components; eval at the fit points "
          f"vs klean's model: max|diff|/|1 + model| = {rpost['fit_err']:.3e} "
          f"(bound {FTOL})")
    print(f"[post] MFS residual vs klean's, over the pg path's MFS dirty "
          f"peak: degrid -> DATA-MODEL_DATA -> grid {rpost['regrid_err']:.3e}"
          f", transfer_model_from {rpost['transfer_err']:.3e} (bound {XTOL})")
    print(f"[post] fluxmop: MFS residual peak / MFS dirty peak "
          f"{rpost['mop_ratio']:.4f} (bound {MOP_GATE}); (1, {NSPACE}) space "
          f"mesh vs single program: max|diff|/max = "
          f"{rpost['mop_space_err']:.3e} (bound {CTOL}); its Hessian "
          f"{rpost['mop_space_route']!r}")
    print(f"[post] restore wrote {rpost['fits']}")
    srcs = source_checks({"model": rpost["image_mfs"][None]}, truth)
    for s in srcs:
        print(f"[post] image_mfs source {s}")
    need(rpost["fit_err"] <= FTOL, f"mds vs klean's model {rpost['fit_err']}")
    k6, nb = lp["degrid"]["K6"], rpost["nband"]
    need(k6 == nb == rpost["degrid"]["nimages"], f"degrid launched K6 {k6} "
         f"times for {rpost['degrid']['nimages']} images of {nb} bands")
    for k in ("K3c", "K3r"):
        need(lp["degrid"][k] > 0, f"{k} never launched inside _degrid")
    need(lp["degrid"]["K3"] == 0, "K3 (line kernel) launched inside _degrid")
    need(rpost["regrid_err"] <= XTOL, f"degrid -> regrid residual "
         f"{rpost['regrid_err']} > {XTOL}")
    need(rpost["transfer_err"] <= XTOL, f"transfer_model_from residual "
         f"{rpost['transfer_err']} > {XTOL}")
    for stage in ("transfer", "fluxmop"):
        for k in ("K4", "K5", "K6"):
            need(lp[stage][k] > 0, f"{k} never launched inside {stage}")
    want = {f".{n}.fits" for n in ("model", "residual", "image")} | \
        {f".{n}_mfs.fits" for n in ("model", "residual", "image", "cpsf")}
    need({f[len("post_I_main"):] for f in rpost["fits"]} == want,
         f"restore wrote {rpost['fits']}")
    need(np.isfinite(rpost["image_mfs"]).all(), "image_mfs not finite")
    need(all(s["local_max"] for s in srcs),
         f"restore: bright sources not at their pixels: {srcs}")
    need(rpost["mop_ratio"] < MOP_GATE, f"fluxmop residual ratio "
         f"{rpost['mop_ratio']} >= {MOP_GATE}")
    need(rpost["mop_space_err"] <= CTOL, f"fluxmop space mesh vs single "
         f"program {rpost['mop_space_err']} > {CTOL}")
    need(rpost["mop_space_route"] == f"psf space mesh (1, {NSPACE})",
         f"the space-sharded fluxmop ran {rpost['mop_space_route']!r}: "
         "not the mesh Hessian")
    for k in ("K10a", "K10b", "K10c", "K10ac", "K10cc", "K10br"):
        need(lp["fluxmop_space"][k] == 0,
             f"{k} launched inside the space-sharded fluxmop")


@contextlib.contextmanager
def plain_gridder(planes=None):
    """Inside the block the pg gridder runs its kernels' plain versions:
    K4, K5 and K6 in ops/pgridder.py and the plane transforms (K3, K3c,
    K3r, K3xl, K3yl, through ops/cfft.py:fft2_c2c_pruned) in
    ops/wgridder.py, ``planes`` planes of a stack at a time (None: the
    whole stack; torch.fft takes several times a stack's size)."""
    import torch

    from pfb_tpu_torch.ops import pgridder as pg
    from pfb_tpu_torch.ops import wgridder as wg

    def fold(Yc, slots, *, ntx, **kw):
        return pg.pg_fold_plain(Yc, slots, **kw)

    def fft2(xr, xi, *, Nx, Ny, inverse, pruned_in=False,
             pruned_out=False):
        step = planes or xr.shape[0]
        parts = [_fft2_pruned_plain(xr[p:p + step], xi[p:p + step], Nx, Ny,
                                    inverse, pruned_in, pruned_out)
                 for p in range(0, xr.shape[0], step)]
        if len(parts) == 1:
            return parts[0]
        return tuple(torch.cat([q[k] for q in parts]) for k in (0, 1))

    swap = ((pg, "pg_spread", pg.pg_spread_plain), (pg, "pg_fold", fold),
            (pg, "pg_degrid", pg.pg_degrid_plain),
            (wg, "fft2_c2c_pruned", fft2))
    kept = [(m, n, getattr(m, n)) for m, n, _ in swap]
    for m, n, f in swap:
        setattr(m, n, f)
    try:
        yield
    finally:
        for m, n, f in kept:
            setattr(m, n, f)


def snapshot_kernel_checks(truth, mds, device, nx, cell_rad):
    """fastim's first snapshot (its first SNAP integrations, every
    channel, weighted as fastim weights them) through the pg backend's
    vis2dirty, and its first model sub-band (two channels, the mds
    rendered as fastim renders it) through dirty2vis, each on the
    snapshot's own plan: once through the kernels and once inside
    plain_gridder, the counts set to 0 just before each call and read
    just after. Returns (records, launches, plan summaries)."""
    import numpy as np
    import torch

    from pfb_tpu_torch.models.comps import eval_mds_to_slice
    from pfb_tpu_torch.ops.pgridder import (dirty2vis_pg, pgrid_plan,
                                            vis2dirty_pg)
    from pfb_tpu_torch.utils.ms import read_ms
    from pfb_tpu_torch.utils.stokes import unity_jones, weight_data
    from pfb_tpu_torch.workers.init import _column_expr

    msd = read_ms(truth["ms"])
    utime, tbin = np.unique(msd["TIME"], return_inverse=True)
    rows = np.where(tbin < SNAP["integrations_per_image"])[0]
    data = _column_expr(msd, "DATA")[rows]
    flag = msd.get("FLAG", np.zeros(data.shape, bool))[rows].any(axis=-1)
    wgt = msd.get("WEIGHT_SPECTRUM", np.ones(data.shape))[rows]
    a1, a2 = msd["ANTENNA1"][rows], msd["ANTENNA2"][rows]
    freq = np.asarray(msd["FREQ"], np.float64)
    nant = int(max(a1.max(), a2.max())) + 1

    def dev(a, dt=None):
        t = torch.as_tensor(np.ascontiguousarray(a))
        return t.to(device) if dt is None else t.to(device=device, dtype=dt)

    f32 = torch.float32
    mask = dev((~flag).astype(np.uint8))
    vis, wout = weight_data(
        dev(data, torch.complex64), dev(wgt, f32),
        dev(flag.astype(np.uint8)),
        dev(unity_jones(utime.size, nant, freq.size), torch.complex64),
        dev(tbin[rows]), dev(a1), dev(a2),
        pol=str(msd.get("POLTYPE", "linear")))
    uvw = dev(msd["UVW"][rows], f32)
    fsub = freq[:2]
    image = eval_mds_to_slice(mds, float(np.mean(utime[:SNAP[
        "integrations_per_image"]])), float(np.mean(fsub)), nx, nx,
        cell_rad, 0.0, 0.0)
    image = dev(image, f32)
    pkw = dict(nx=nx, ny=nx, cellx=cell_rad, celly=cell_rad,
               epsilon=SNAP["epsilon"], dtype=f32, device=device)
    pv = pgrid_plan(uvw, dev(freq, f32), **pkw)
    pd = pgrid_plan(uvw, dev(fsub, f32), **pkw)

    def v2d():
        return vis2dirty_pg(uvw, None, vis, wgt=wout, mask=mask, plan=pv,
                            nx=nx, ny=nx, cellx=cell_rad, celly=cell_rad)

    def d2v():
        return torch.stack(dirty2vis_pg(uvw, None, image, cell_rad,
                                        cell_rad, plan=pd, split=True))

    cnt = counters()
    recs, launches = [], {}
    for tag, fn, name in (
            ("v2d", v2d, "fastim snapshot vis2dirty (K4, K5, K3c, K3r)"),
            ("d2v", d2v, "fastim sub-band dirty2vis (K6, K3c, K3r)")):
        out = {}
        for run in ("kernel", "plain"):
            for c in cnt.values():
                c.launches = 0
            with plain_gridder() if run == "plain" else \
                    contextlib.nullcontext():
                out[run] = fn()
            sync(device)
            launches[f"{tag}_{run}"] = {k: c.launches
                                        for k, c in cnt.items()}
        recs.append(_record(name, out["plain"].shape, out["kernel"],
                            out["plain"], None, None, False))
        del out
    return recs, launches, {"vis2dirty": plan_summary(pv),
                            "dirty2vis": plan_summary(pd)}


def imaging_path(rpg, mds, truth, device, workdir, nx=NX,
                 ntime=SIM["ntime"]):
    """Phase 28: fwdbwd(pg) on copies of the pg path's dds as _grid left
    them (no MODEL), written to a dds store; fastim(pg) on the
    observation at the pg path's 2048^2 grid, with no model and with
    phase 27's mds degridded two channels a sub-band, each against one
    fastim call of the whole observation; smoovie on the model-free
    snapshots. Every step's counts, seconds and peak device memory as in
    phase 27; returns them with the outputs the gates read."""
    import shutil

    import numpy as np

    from pfb_tpu_torch.workers.fastim import _fastim
    from pfb_tpu_torch.workers.fwdbwd import _fwdbwd
    from pfb_tpu_torch.workers.smoovie import _smoovie

    res = {"t": {}, "peak_gib": {}, "launches": {}}

    def step(name, fn):
        return timed_step(res, device, name, fn)

    drop = ("MODEL", "MODEL_BEST", "RESIDUAL", "DUAL", "PARAM", "MODELP",
            "UPDATE", "parametrisation")
    dds = [{k: v for k, v in ds.items() if k not in drop}
           for ds in rpg["dds"]]
    base = str(Path(workdir) / "fwdbwd")
    shutil.rmtree(base + "_I_main.dds", ignore_errors=True)
    st = {}
    _, _, resid = step("fwdbwd", lambda: _fwdbwd(
        ddsi=dds, output_filename=base, device=device, stats=st, verbose=0,
        **FWD))
    dirty_max = float(np.abs(mfs_over_wsum(rpg["dds"], "DIRTY")).max())
    res["fwd_ratio"] = float(np.abs(resid.sum(axis=0)).max() / dirty_max)
    res["fwd_param"] = (Path(base + "_I_main.dds") / "ds_0000" /
                        "PARAM").is_dir()
    res["fwd_stats"] = st
    del dds, resid

    # the pg path's cell in arcsec, as fastim takes it; its conversion
    # back may differ by an ulp, so the mds takes fastim's cell exactly
    # and renders on the same grid without a regrid
    cell_rad = rpg["dds"][0]["cell_rad"]
    cell_arcsec = float(np.rad2deg(cell_rad)) * 3600
    cell_f = cell_arcsec * np.pi / 60 / 60 / 180
    need(abs(cell_f / cell_rad - 1) < 1e-12, f"fastim's cell {cell_f}")
    mds = dict(mds, cell_rad_x=cell_f, cell_rad_y=cell_f)
    fkw = dict(SNAP, ms=truth["ms"], nx=nx, cell_size=cell_arcsec,
               write=False, device=device)
    res["nsnap"] = ntime // SNAP["integrations_per_image"]
    for tag, extra in (("fastim", {}),
                       ("fastim_mds", dict(mds=mds,
                                           channels_per_degrid_image=2))):
        snaps = step(tag, lambda: _fastim(**fkw, **extra))
        one = step(tag + "_one", lambda: _fastim(
            **dict(fkw, integrations_per_image=ntime), **extra))
        total = sum(ds["RESIDUAL"].astype(np.float64) for ds in snaps)
        whole = one[0]["RESIDUAL"].astype(np.float64)
        if tag == "fastim":
            dirty_peak = float(np.abs(whole).max())
        ws = sum(float(ds["WSUM"][0]) for ds in snaps)
        diff = float(np.abs(total - whole).max())
        res[tag] = dict(
            nsnap=len(snaps), none=len(one),
            snaps_per_s=len(snaps) / res["t"][tag],
            rel=diff / float(np.abs(whole).max()), rel_dirty=diff / dirty_peak,
            wsum_rel=abs(ws - float(one[0]["WSUM"][0])) / ws,
            finite=bool(all(np.isfinite(ds["RESIDUAL"]).all()
                            for ds in snaps)))
        if tag == "fastim":
            fds = snaps
        del snaps, one, total, whole
    res["snap_recs"], res["snap_launches"], res["snap_plans"] = \
        snapshot_kernel_checks(truth, mds, device, nx, cell_f)

    movie = Path(workdir) / "fastim_I_movie.gif"
    if movie.exists():
        movie.unlink()
    frames = step("smoovie", lambda: _smoovie(
        fdsi=fds, output_filename=str(Path(workdir) / "fastim"),
        animate_axis="time", time_bin=2, out_format="gif"))
    res["frames"] = len(frames)
    res["frames_finite"] = bool(all(np.isfinite(f).all() for f in frames))
    res["movie"] = movie.exists()
    return res


def report_imaging(rim):
    """Print phase 28's stage seconds, peak memory, launches and gate
    readings; check its gates."""
    lp = rim["launches"]
    print("[imaging] " + json.dumps({
        "seconds": {k: round(v, 3) for k, v in rim["t"].items()},
        "peak_gib": {k: round(v, 3) for k, v in rim["peak_gib"].items()},
        "launches": {s: {k: v for k, v in c.items() if v}
                     for s, c in lp.items()}}))
    st = rim["fwd_stats"]
    print(f"[imaging] fwdbwd(pg, id, {FWD['niter']} majors): MFS residual "
          f"peak / MFS dirty peak {rim['fwd_ratio']:.4f} (bound {FWD_GATE});"
          f" PARAM written: {rim['fwd_param']}; hessnorm "
          f"{[round(h, 3) for h in st['hessnorm']]}, rms "
          f"{[float(f'{r:.6e}') for r in st['rms']]}; exact residuals "
          f"{st['t_exact']:.3f} s of {st['t_loop']:.3f} s")
    for tag in ("fastim", "fastim_mds"):
        f = rim[tag]
        print(f"[imaging] {tag}: {f['nsnap']} snapshots, "
              f"{f['snaps_per_s']:.2f} snapshots/s; their RESIDUAL sum vs "
              f"the one image: max|diff| over the one image's peak "
              f"{f['rel']:.3e}, over the model-free image's peak "
              f"{f['rel_dirty']:.3e} (bound {SNAPTOL}), WSUM "
              f"{f['wsum_rel']:.3e} (bound {WTOL})")
    print("[imaging] the first snapshot's plans " + json.dumps(
        rim["snap_plans"]))
    for r in rim["snap_recs"]:
        print("[kernel] " + json.dumps(r))
    sl = rim["snap_launches"]
    print("[imaging] its kernel and plain calls launched " + json.dumps(
        {s: {k: v for k, v in c.items() if v} for s, c in sl.items()}))
    print(f"[imaging] smoovie: {rim['frames']} frames, finite "
          f"{rim['frames_finite']}, movie written {rim['movie']}")
    need(rim["fwd_ratio"] < FWD_GATE, f"fwdbwd residual ratio "
         f"{rim['fwd_ratio']} >= {FWD_GATE}")
    need(rim["fwd_param"], "fwdbwd wrote no PARAM")
    for k in ("K3c", "K3r", "K4", "K5", "K6"):
        need(lp["fwdbwd"][k] > 0, f"{k} never launched inside fwdbwd")
    for k in ("K1", "K2", "K11", "K10ac", "K10cc", "K10br"):
        need(lp["fwdbwd"][k] == 0, f"{k} launched inside fwdbwd")
    nsnap = rim["nsnap"]
    for tag, k6 in (("fastim", 0), ("fastim_mds", 4)):
        f, lc = rim[tag], lp[tag]
        need(f["nsnap"] == nsnap and f["none"] == 1, f"{tag}: "
             f"{f['nsnap']} snapshots and {f['none']} whole images")
        need(f["finite"], f"{tag}: non-finite snapshot")
        need(f["rel_dirty"] <= SNAPTOL, f"{tag}: snapshot sum vs one image "
             f"{f['rel_dirty']} of the model-free peak > {SNAPTOL}")
        need(f["wsum_rel"] <= WTOL, f"{tag}: WSUM {f['wsum_rel']} > {WTOL}")
        for k in ("K4", "K5"):
            need(lc[k] >= nsnap, f"{tag}: {k} launched {lc[k]} times for "
                 f"{nsnap} snapshots")
        need(lc["K6"] >= k6 * nsnap if k6 else lc["K6"] == 0,
             f"{tag}: K6 launched {lc['K6']} times for {nsnap} snapshots")
        need(lc["K3"] == 0, f"{tag}: K3 (line kernel) launched")
    bad = [r["name"] for r in rim["snap_recs"] if not r["ok"]]
    need(not bad, f"kernel disagrees with its plain version: {bad}")
    for tag, ks in (("v2d", ("K4", "K5", "K3c", "K3r")),
                    ("d2v", ("K6", "K3c", "K3r"))):
        for k in ks:
            need(sl[f"{tag}_kernel"][k] > 0, f"the first snapshot's {tag}:"
                 f" {k} never launched")
        need(sl[f"{tag}_kernel"]["K3"] == 0,
             f"the first snapshot's {tag}: K3 (line kernel) launched")
        need(not any(sl[f"{tag}_plain"].values()), f"the first snapshot's "
             f"{tag}: a kernel launched inside plain_gridder")
    need(rim["frames"] == nsnap // 2 and rim["frames_finite"],
         f"smoovie: {rim['frames']} frames, finite {rim['frames_finite']}")
    need(rim["movie"], "smoovie wrote no movie")


# phase 29's recipe: phase 6's init -> grid -> spotless through the CLI,
# with every parameter whose schema default differs from what main_path
# passes stated (tests/test_torch_cli.py holds the resolved arguments
# against INIT, GRID_PG and SPOT_PG)
RECIPE = """steps:
  - worker: init
    params: {{ms: {ms}, output-filename: {out}, channels-per-image: 1,
             precision: single, weight-column: null, overwrite: true}}
  - worker: grid
    params: {{output-filename: {out}, backend: pg, nx: {nx}, ny: {nx},
             robustness: 0.0, psf: true, residual: false,
             epsilon: 1.0e-5, fits-mfs: false, overwrite: true}}
  - worker: spotless
    params: {{output-filename: {out}, engine: pallas, backend: pg,
             epsilon: 1.0e-5, bases: 'self,db1,db2', nlevels: 3,
             niter: 3, pd-maxit: 100, diverge-count: 3, fits-mfs: false,
             verbose: 0, pm-verbose: 0, pd-verbose: 0}}
"""
CLI_STAGES = ("init", "grid", "spotless")
# phase 29's profiled command: the recipe's grid on its own (a trace of the
# whole recipe measured 200 MB at 128^2 on the CPU, most of it the
# solver's small operations), into another output name
CLI_GRID = ["grid", "--backend", "pg", "--robustness", "0.0", "--psf",
            "--no-residual", "--epsilon", "1e-5", "--no-fits-mfs",
            "--overwrite"]
MP_TIMEOUT = 300  # seconds each phase-30 process may take
PM = dict(tol=1e-5, maxit=100)  # phase 30's power method (spotless's pm)


def cli_recipe(ms, out, nx=NX):
    return RECIPE.format(ms=ms, out=out, nx=nx)


def port_kernel_names():
    """The __global__ functions of pfb_tpu_torch/csrc."""
    import re
    names = set()
    for src in (Path(__file__).resolve().parent / "pfb_tpu_torch" /
                "csrc").glob("*.cu*"):
        names.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                                r"\((?:[^()]|\([^()]*\))*\)\s+)?(\w+)",
                                src.read_text()))
    return names


def trace_kernels(path):
    """(events of the port's kernels by name, every kernel event) in a
    torch.profiler Chrome trace."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    names = port_kernel_names()
    ours, nkern = {}, 0
    for e in events:
        if e.get("cat") != "kernel":
            continue
        nkern += 1
        for n in names:
            if n in e.get("name", ""):
                ours[n] = ours.get(n, 0) + 1
    return ours, nkern


def cli_path(truth, rpg, device, workdir, nx=NX):
    """Phase 29: phase 6's path through the CLI's ``pipeline`` command in
    this process, then the recipe's grid step as a ``grid`` command of its
    own under ``--profile-dir``; returns the stage launches (counts reset
    before the recipe and read at each step's start and after it, and
    around the profiled command), the read-back model and residual
    against phase 6's and the trace."""
    import logging
    import shutil

    import numpy as np
    import torch

    from pfb_tpu_torch.utils import dstore
    from pfb_tpu_torch.utils.profiling import stop_profile
    from pfb_tpu_torch.workers.cubes import dds2cubes
    from pfb_tpu_torch.workers.main import cli

    wd = Path(workdir) / "cli"
    shutil.rmtree(wd, ignore_errors=True)
    wd.mkdir(parents=True)
    out = str(wd / "out")
    recipe = wd / "recipe.yaml"
    recipe.write_text(cli_recipe(truth["ms"], out, nx))
    cnt = counters()
    snaps = []

    class StepCounts(logging.Handler):
        def emit(self, record):
            if record.getMessage().startswith("step "):
                snaps.append({k: c.launches for k, c in cnt.items()})

    handler = StepCounts()
    plog = logging.getLogger("pfb_tpu_torch.PIPELINE")
    for c in cnt.values():
        c.launches = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    plog.addHandler(handler)
    t0 = time.perf_counter()
    try:
        cli.main(["--device", str(device), "pipeline", str(recipe)],
                 standalone_mode=False)
        sync(device)
    finally:
        plog.removeHandler(handler)
    res = dict(t={"recipe": time.perf_counter() - t0}, store=out +
               "_I_main.dds")
    snaps.append({k: c.launches for k, c in cnt.items()})
    need(len(snaps) == len(CLI_STAGES) + 1,
         f"the pipeline logged {len(snaps) - 1} steps, not "
         f"{len(CLI_STAGES)}")
    res["launches"] = {st: {k: snaps[i + 1][k] - snaps[i][k] for k in cnt}
                       for i, st in enumerate(CLI_STAGES)}
    if device.type == "cuda":
        res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30

    for c in cnt.values():
        c.launches = 0
    t0 = time.perf_counter()
    cli.main(["--device", str(device), "--profile-dir", str(wd / "prof")] +
             CLI_GRID + ["--xds", out + "_I.xds", "-o", str(wd / "prof_out"),
                         "--nx", str(nx), "--ny", str(nx)],
             standalone_mode=False)
    sync(device)
    res["t"]["grid_profiled"] = time.perf_counter() - t0
    res["launches"]["grid_profiled"] = {k: c.launches for k, c in
                                        cnt.items()}
    t0 = time.perf_counter()
    trace = stop_profile()
    res["t"]["trace_export"] = time.perf_counter() - t0
    need(trace is not None and Path(trace).exists(),
         f"no trace under {wd / 'prof'}")
    res["trace_bytes"] = Path(trace).stat().st_size
    res["trace_ours"], res["trace_kernels"] = trace_kernels(trace)

    dds = dstore.read_store(res["store"])
    wsum = dds2cubes(dds, len(dds))[6].sum()
    model = np.stack([ds["MODEL"] for ds in dds])
    resid = np.stack([ds["RESIDUAL"] for ds in dds])
    resid6 = np.stack([rpg["residual"][ds["bandid"]] * wsum for ds in dds])
    peak = float(np.abs(mfs_over_wsum(rpg["dds"], "DIRTY")).max())
    res["model_err"] = float(np.abs(model - rpg["model"]).max()) / peak
    res["mfs_resid_err"] = float(np.abs(resid.sum(0) - resid6.sum(0)).max()
                                 / wsum) / peak
    res["model_bitwise"] = bool(np.array_equal(model, rpg["model"]))
    res["resid_bitwise"] = bool(np.array_equal(resid, resid6))
    return res


def report_cli(rcli, lp):
    """Print phase 29's seconds, memory, launches, trace and errors, and
    gate them against phase 6's launches ``lp``."""
    print(f"[cli] pipeline recipe (init -> grid -> spotless) "
          f"{rcli['t']['recipe']:.3f} s, peak device memory "
          f"{rcli.get('peak_mem_gb', 0.0):.2f} GiB; grid command under "
          f"--profile-dir {rcli['t']['grid_profiled']:.3f} s, trace export "
          f"{rcli['t']['trace_export']:.3f} s")
    print("[cli] launches " + json.dumps(
        {st: {k: v for k, v in lc.items() if v}
         for st, lc in rcli["launches"].items()}))
    print(f"[cli] trace {rcli['trace_bytes']} bytes, {rcli['trace_kernels']}"
          f" kernel events, the port's kernels " +
          json.dumps(rcli["trace_ours"]))
    print(f"[cli] read back vs phase 6, over the MFS dirty peak: model "
          f"{rcli['model_err']:.3e} (bitwise {rcli['model_bitwise']}), MFS "
          f"residual {rcli['mfs_resid_err']:.3e} (residual cube bitwise "
          f"{rcli['resid_bitwise']}), bound {TOL}")
    need(max(rcli["model_err"], rcli["mfs_resid_err"]) <= TOL,
         f"the CLI's model / residual differ from phase 6's: "
         f"{rcli['model_err']}, {rcli['mfs_resid_err']}")
    lc = rcli["launches"]
    for k in ("K1", "K3c", "K3r", "K4", "K5", "K6"):
        grid = lc["init"][k] + lc["grid"][k]
        need(grid == lp["grid"][k] and lc["spotless"][k] ==
             lp["spotless"][k], f"CLI {k} launches init+grid {grid}, "
             f"spotless {lc['spotless'][k]}; phase 6 {lp['grid'][k]}, "
             f"{lp['spotless'][k]}")
        need(lc["grid_profiled"][k] == lc["grid"][k], f"the profiled grid "
             f"command launched {k} {lc['grid_profiled'][k]} times, the "
             f"recipe's grid {lc['grid'][k]}")
    need(all(lc[st]["K3"] == 0 for st in lc), "K3 launched on the CLI path")
    need(rcli["trace_ours"], "the profiler trace names none of the port's "
         "kernels")


# one process of phase 30: joins the mesh, runs mesh_runs, writes its npz
MP_CHILD = r"""
import json, sys, time
t_start = time.perf_counter()
root, port, rank, store, out, nx, dev = sys.argv[1:8]
sys.path.insert(0, root)
import numpy as np
import chip_smoke as cs
from pfb_tpu_torch.parallel.runtime import set_client
t0 = time.perf_counter()
set_client(coordinator=f"127.0.0.1:{port}", num_processes=2,
           process_id=int(rank), devices=[dev])
t_join = time.perf_counter() - t0
r = cs.mesh_runs(store, int(nx), dev, 1)
r["t"]["join"] = t_join
r["t"]["process"] = time.perf_counter() - t_start
np.savez(out, band=r.pop("band"), space=r.pop("space"),
         info=json.dumps(r))
"""


def mesh_runs(store, nx, dev, nvirtual, checks=False):
    """Phase 30's work on this process's part of a (2, 1) band mesh and a
    (1, 2) space mesh, ``nvirtual`` shards of each on ``dev`` (2 in one
    process, 1 in each of two): the PSF and model of the dds ``store``,
    hessian_psf_dist(engine="pallas") and power_method_dist on the band
    mesh and hessian_psf_space_dist(method="pallas") on the space mesh,
    each gathered to the host, with launches and seconds. With
    ``checks``, also K1 on the whole cube ("k1", what the space matvec is
    held to) and K10's stages against their plain versions at the (1, 2)
    mesh's shard shapes ("k10_recs"), each with its counts reset before
    it."""
    import numpy as np
    import torch

    from pfb_tpu_torch.ops.psf import prep_h, prep_h_space, psf_convolve_h
    from pfb_tpu_torch.parallel.dist import (hessian_psf_dist,
                                             hessian_psf_space_dist,
                                             power_method_dist)
    from pfb_tpu_torch.parallel.mesh import make_mesh
    from pfb_tpu_torch.utils import dstore
    from pfb_tpu_torch.workers.cubes import dds2cubes
    dev = torch.device(dev)
    cnt = counters()
    res = {"t": {}, "launches": {}}

    def step(name, fn):
        for c in cnt.values():
            c.launches = 0
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        res["t"][name] = time.perf_counter() - t0
        res["launches"][name] = {k: c.launches for k, c in cnt.items()
                                 if c.launches}
        return out

    t0 = time.perf_counter()
    dds = dstore.read_store(store)
    cubes = dds2cubes(dds, len(dds))
    psf = torch.as_tensor(cubes[3], dtype=torch.float32, device=dev)
    x = torch.as_tensor(np.ascontiguousarray(cubes[1]), dtype=torch.float32,
                        device=dev)
    del dds, cubes
    if dev.type == "cuda":
        # after the first allocation: a fresh process's allocator refuses
        # the reset before it
        torch.cuda.reset_peak_memory_stats(dev)
    res["t"]["read"] = time.perf_counter() - t0
    h = [a for a in prep_h(psf, nx, nx, torch.float32) if a is not None]
    band = make_mesh(nband=2, nspace=1, devices=[dev] * nvirtual)
    hess = hessian_psf_dist(band, engine="pallas")
    res["band"] = step("band", lambda: hess(x, *h).gather()).cpu().numpy()
    pm = power_method_dist(band, engine="pallas", **PM)
    res["beta"] = float(step("power", lambda: pm(x, *h)[0]))
    del h
    hs = [a for a in prep_h_space(psf, nx, nx, 2, torch.float32)
          if a is not None]
    space = make_mesh(nband=1, nspace=2, devices=[dev] * nvirtual)
    sp = hessian_psf_space_dist(space, method="pallas")
    res["space"] = step("space", lambda: sp(x, *hs).gather()).cpu().numpy()
    if checks:
        h1 = [a[:, :nx + 1].contiguous() for a in hs]
        res["k1"] = step("k1", lambda: psf_convolve_h(x, *h1)).cpu().numpy()
        del h1, hs
        res["k10_recs"] = step("k10_plain", lambda: k10_checks(
            psf, nx, 2, dev, timing=False, nbl=psf.shape[0]))
    del psf
    if dev.type == "cuda":
        res["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return res


def mesh_procs(store, nx, device, workdir):
    """Phase 30: mesh_runs in two processes joined by set_client and in
    this one on one-process meshes of the same shapes; returns both."""
    import socket

    import numpy as np
    import torch
    root = str(Path(__file__).resolve().parent)
    dev = str(torch.device(device.type, 0) if device.type == "cuda"
              else device)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    outs = [str(Path(workdir) / f"mesh{r}.npz") for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", MP_CHILD, root, str(port), str(r), store,
         outs[r], str(nx), dev], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=MP_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    for r, (p, lg) in enumerate(zip(procs, logs)):
        need(p.returncode == 0, f"phase-30 process {r} exited "
             f"{p.returncode}: {lg[-3000:]}")
    kids = []
    for o in outs:
        with np.load(o) as d:
            k = json.loads(str(d["info"]))
            k.update(band=d["band"], space=d["space"])
        kids.append(k)
    one = mesh_runs(store, nx, dev, 2, checks=True)
    return dict(kids=kids, one=one, wall=wall)


def report_mesh(rm):
    """Print phase 30's backend, seconds, launches and agreement, and gate
    them."""
    import numpy as np
    one = rm["one"]
    print(f"[mesh] two processes, gloo (host-staged), both done in "
          f"{rm['wall']:.3f} s; one-process meshes " + json.dumps(
              {k: round(v, 3) for k, v in one["t"].items()}) +
          f", peak {one.get('peak_mem_gb', 0.0):.2f} GiB")
    err = float(np.abs(one["space"] - one["k1"]).max()
                / np.abs(one["k1"]).max())
    print(f"[mesh] one-process space matvec vs K1 on the whole cube: "
          f"max|diff|/max = {err:.3e} (bound {STOL}), bitwise "
          f"{bool(np.array_equal(one['space'], one['k1']))}")
    need(err <= STOL, f"one-process space matvec vs K1 {err} > {STOL}")
    need(one["launches"]["k1"].get("K1", 0) > 0, "the whole-cube reference "
         "launched no K1")
    for r in one["k10_recs"]:
        print("[mesh] [kernel] " + json.dumps(r))
    bad = [r["name"] for r in one["k10_recs"] if not r["ok"]]
    need(not bad, f"K10 disagrees with its plain version at the (1, 2) "
         f"mesh's shard shapes: {bad}")
    for r, k in enumerate(rm["kids"]):
        print(f"[mesh] process {r} seconds " + json.dumps(
            {a: round(v, 3) for a, v in k["t"].items()}) + ", peak device "
            f"memory {k.get('peak_mem_gb', 0.0):.2f} GiB")
        print(f"[mesh] process {r} launches " + json.dumps(k["launches"]))
        for key in ("band", "space"):
            ref = one[key]
            err = float(np.abs(k[key] - ref).max() / np.abs(ref).max())
            bit = bool(np.array_equal(k[key], ref))
            print(f"[mesh] process {r} {key} matvec vs one process: "
                  f"max|diff|/max = {err:.3e} (bound {STOL}), bitwise {bit}")
            need(err <= STOL, f"process {r} {key} matvec {err} > {STOL}")
        berr = abs(k["beta"] - one["beta"]) / abs(one["beta"])
        print(f"[mesh] process {r} beta {k['beta']:.9e} vs {one['beta']:.9e}"
              f": {berr:.3e} relative (bound {STOL}), bitwise "
              f"{k['beta'] == one['beta']}")
        need(berr <= STOL, f"process {r} beta {berr} > {STOL}")
        lc = k["launches"]
        need(lc["band"].get("K1", 0) > 0 and lc["power"].get("K1", 0) > 0,
             f"process {r} launched no K1 on the band mesh")
        for s in ("K10a", "K10b", "K10c"):
            need(lc["space"].get(s, 0) > 0, f"process {r} launched no {s} "
                 "on the space mesh")


# phase 31: backend "mm" (the JAX package's matmul gridder, which the
# port runs on the pg gridder) on phase 6's xds, and the joint multi-field
# solve on one band's dataset
GRID_MM = dict(GRID_PG, backend="mm")
NX_JOINT = 1024  # each field of the joint solve
JOINT_WIDTHS = 60  # field widths between the two (tests/test_ingest.py:150)
# w-stacking at that offset (|l| ~ 0.49) would need thousands of w planes
# (joint_solve counts them), so the joint operator grids without the w term
JOINT = dict(backend="mm", epsilon=1e-5, do_wgridding=False, sigmainv=1e-6)
JOINT_ITERS = 20
JTOL = 1e-4  # the joint operator's self-adjointness in float32, relative


def joint_solve(ds, vis, device, n=NX_JOINT):
    """make_hess_vis_dct(backend="mm") on one dataset with two NX_JOINT^2
    fields, the second JOINT_WIDTHS field widths away, b the two fields'
    dirty images of ``vis``: the self-adjointness <v, H u> against
    <H v, u> on random u, v, and cg_dct's residual after JOINT_ITERS
    iterations against b's."""
    import numpy as np
    import torch

    from pfb_tpu_torch.ops.gridder import get_backend, make_hess_vis_dct
    from pfb_tpu_torch.ops.wgridder import _nm1_min, _w_params, kernel_params
    from pfb_tpu_torch.opt.pcg import cg_dct
    cell = float(ds["cell_rad"])
    geom = {"f0": dict(nx=n, ny=n, cell_rad=cell, x0=0.0, y0=0.0),
            "f1": dict(nx=n, ny=n, cell_rad=cell,
                       x0=JOINT_WIDTHS * n * cell, y0=0.0)}
    k, _ = kernel_params(JOINT["epsilon"])
    nw_w = _w_params(np.asarray(ds["UVW"]), np.asarray(ds["FREQ"]),
                     _nm1_min(n, n, cell, cell, geom["f1"]["x0"], 0.0),
                     2.0, k)[0]
    kw = {key: JOINT[key] for key in ("backend", "epsilon", "do_wgridding")}
    vds = dict(key="b0", **{key: ds[key] for key in
                            ("UVW", "FREQ", "WEIGHT", "MASK")})
    hess = make_hess_vis_dct([vds], geom, sigmainv=JOINT["sigmainv"],
                             device=device, **kw)
    _, v2d = get_backend(kw["backend"], kw["epsilon"], kw["do_wgridding"])
    t = {key: torch.as_tensor(np.asarray(ds[key])).to(device, torch.float32)
         for key in ("UVW", "FREQ", "WEIGHT", "MASK")}
    vis = torch.as_tensor(np.asarray(vis)).to(device, torch.complex64)
    b = {f: {"b0": v2d(t["UVW"], t["FREQ"], vis, wgt=t["WEIGHT"],
                       mask=t["MASK"], nx=n, ny=n, cellx=cell, celly=cell,
                       x0=g["x0"], y0=g["y0"])} for f, g in geom.items()}
    gen = torch.Generator(device=device).manual_seed(0)

    def rand():
        return {f: {"b0": torch.randn((n, n), generator=gen, device=device)}
                for f in geom}

    def dot(a, c):
        return sum(float((a[f]["b0"].double() * c[f]["b0"].double()).sum())
                   for f in geom)

    u, v = rand(), rand()
    vhu, hvu = dot(v, hess(u)), dot(hess(v), u)
    x0 = {f: {"b0": torch.zeros((n, n), device=device)} for f in geom}
    _, r = cg_dct(hess, b, x0, tol=0.0, maxit=JOINT_ITERS)
    return dict(n=n, nw_with_w=int(nw_w),
                adjoint_rel=abs(vhu - hvu) / abs(vhu),
                bnorm=dot(b, b), rnorm=dot(r, r))


def mm_path(rpg, device, nx=NX, nx_joint=NX_JOINT):
    """Phase 31: grid(backend="mm") on the pg path's xds, against the pg
    path's products, then the joint solve. Each step's counts are set to
    0 just before it and read just after, with its seconds and peak
    device memory; returns them with the readings the gates take."""
    import numpy as np
    import torch

    from pfb_tpu_torch.workers.grid import _grid

    res = {"t": {}, "peak_gib": {}, "launches": {}}

    def step(name, fn):
        return timed_step(res, device, name, fn)

    if device.type == "cuda":
        torch.cuda.empty_cache()
    dds = step("grid", lambda: _grid(xdsi=rpg["xds"], write=False,
                                     device=device,
                                     **dict(GRID_MM, nx=nx, ny=nx)))
    keys = ("DIRTY", "PSF")
    res["grid_err"] = {key: max(
        float(np.abs(a[key] - b[key]).max() / np.abs(b[key]).max())
        for a, b in zip(dds, rpg["dds"])) for key in keys}
    res["grid_bitwise"] = all(np.array_equal(a[key], b[key])
                              for a, b in zip(dds, rpg["dds"])
                              for key in keys)
    del dds
    res["joint"] = step("joint", lambda: joint_solve(
        rpg["dds"][0], rpg["xds"][0]["VIS"], device, n=nx_joint))
    return res


def report_mm(rmm):
    """Print phase 31's stage seconds, peak memory, launches and
    readings, and check its gates."""
    st = rmm["launches"]
    print("[mm] " + json.dumps({
        "seconds": {k: round(v, 3) for k, v in rmm["t"].items()},
        "peak_gib": {k: round(v, 3) for k, v in rmm["peak_gib"].items()},
        "launches": {s: {k: v for k, v in c.items() if v}
                     for s, c in st.items()}}))
    ge, jt = rmm["grid_err"], rmm["joint"]
    print(f"[mm] grid(backend='mm') vs phase 6's grid(backend='pg'), "
          f"max|diff|/max over the datasets: DIRTY {ge['DIRTY']:.3e}, PSF "
          f"{ge['PSF']:.3e} (bound {STOL}); bit for bit: "
          f"{rmm['grid_bitwise']}")
    print(f"[mm] joint solve, two {jt['n']}^2 fields {JOINT_WIDTHS} widths "
          f"apart, " + json.dumps(JOINT) + f" (with the w term: "
          f"{jt['nw_with_w']} w planes): |<v,Hu> - <Hv,u>| / |<v,Hu>| = "
          f"{jt['adjoint_rel']:.3e} (bound {JTOL}); cg_dct "
          f"{JOINT_ITERS} iterations: r.r {jt['rnorm']:.6e} from b.b "
          f"{jt['bnorm']:.6e}")
    for key in ("DIRTY", "PSF"):
        need(ge[key] <= STOL, f"mm vs pg {key} {ge[key]} > {STOL}")
    need(jt["adjoint_rel"] <= JTOL, f"joint operator not self-adjoint: "
         f"{jt['adjoint_rel']}")
    need(jt["rnorm"] < jt["bnorm"], "cg_dct did not bring the joint "
         "residual down")
    for stage, ks in (("grid", ("K4", "K5", "K3c", "K3r")),
                      ("joint", ("K4", "K5", "K6", "K3c", "K3r"))):
        for k in ks:
            need(st[stage][k] > 0, f"{k} never launched inside the mm "
                 f"{stage}")
        need(st[stage]["K3"] == 0, f"K3 launched inside the mm {stage}")


# phase 36: S1 / S2 (csrc/sara.cu) at the card tests' shapes: (nband, nx,
# ny), bases, levels
SARA_SHAPES = [((8, 2048, 2048), ("self", "db1", "db2"), 3),
               ((2, 3072, 3072), ("self", "db1", "db2"), 3),
               ((3, 1350, 1000), ("self", "db1", "db2", "db3", "db4"), 3),
               ((2, 64, 48), ("self", "db1", "db2"), 3),
               ((1, 100, 100), ("self", "db3", "db4"), 2)]


def sara_work(p, nb):
    """(bytes, FP32 operations) of one psi_dot or psi_hdot: the image and
    the packed coefficients each moved once; a level's two stride-2
    passes over nx_in x ny_in, 2 F FMAs an input row point and 4 F an
    output coefficient, as the analysis counts them (the synthesis does
    the same sums the other way)."""
    nbytes = 4 * nb * (p.nx * p.ny + p.nbasis * p.Nymax * p.Nxmax)
    ops = 0
    for sp in p.specs:
        if sp is None:
            continue
        nxi = p.nx
        for k in range(p.nlevel):
            ops += 2 * (2 * sp.F * nxi * sp.sy[k] + 4 * sp.F * sp.sx[k]
                        * sp.sy[k])
            nxi = sp.sx[k]
    return nbytes, nb * ops


def sara_checks(device, shapes=SARA_SHAPES, timing=True):
    """Phase 36: psi_dot (S1) and psi_hdot (S2) against their plain
    versions (float32 on the card, conv1d with TF32 off), CUDA-event
    medians of both routes, the bound of sara_work. Returns the
    records."""
    import torch

    from pfb_tpu_torch.ops import psi as P
    recs = []
    for shape, bases, nl in shapes:
        p = P.make_psi(shape[1], shape[2], bases, nl)
        g = torch.Generator(device=device).manual_seed(36)
        x = torch.randn(shape, generator=g, device=device)
        a = torch.randn((shape[0], p.nbasis, p.Nymax, p.Nxmax), generator=g,
                        device=device)
        tag = f"{tuple(shape)} {','.join(bases)} L{nl}"
        work = sara_work(p, shape[0])
        recs.append(_record(
            f"S1 psi_dot {tag}", shape, P.psi_dot(x, p),
            P.psi_dot_plain(x, p), lambda: P.psi_dot(x, p),
            lambda: P.psi_dot_plain(x, p), timing, work=work))
        recs.append(_record(
            f"S2 psi_hdot {tag}", a.shape, P.psi_hdot(a, p),
            P.psi_hdot_plain(a, p), lambda: P.psi_hdot(a, p),
            lambda: P.psi_hdot_plain(a, p), timing, work=work))
        del x, a
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return recs


def api_inputs(rpg, cubes):
    """What phase 35 keeps of the pg path (phase 6): its datasets (host
    arrays), its grid's cell, and its PSF cube and band weights, on the
    host so that they take no card memory in the phases between."""
    return dict(xds=rpg["xds"], cell=float(rpg["dds"][0]["cell_rad"]),
                psf=cubes[3], wsums=cubes[6])


def _peak_gb(device, fn):
    """(fn(), the card's peak memory during fn above what was allocated
    before it, GiB; 0 on the CPU)."""
    import torch
    if device.type != "cuda":
        return fn(), 0.0
    sync(device)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    sync(device)
    return out, (torch.cuda.max_memory_allocated() - base) / 2**30


def api_path(inp, device, nx=NX, spot=SPOT_PG, seed=35):
    """Phase 35: the JAX package's last public functions on the pg path's
    data. Returns a dict of records; gates nothing itself."""
    import numpy as np
    import torch

    from pfb_tpu_torch.ops.fft import make_psfhat
    from pfb_tpu_torch.ops.prox import dual_update_21
    from pfb_tpu_torch.ops.psf import hessian_psf_cube, hessian_psf_slice
    from pfb_tpu_torch.ops.psi import make_psi
    from pfb_tpu_torch.ops.weighting import (compute_counts,
                                             compute_counts_host,
                                             counts_to_weights)
    out = {"counts": {}}
    cell = inp["cell"]
    # (a) the uv counts on the card against the host builder, every dataset
    for k in (6, 0):
        rec = dict(nvis=0, datasets=len(inp["xds"]), t_card=0.0,
                   t_host=0.0, peak_gb=0.0, rel_err=0.0, cells_differ=0,
                   occupancy_differs=0, weights_rel_err=0.0)
        for ds in inp["xds"]:
            uvw = np.asarray(ds["UVW"], np.float64)
            freq = np.asarray(ds["FREQ"], np.float64)
            mask = np.asarray(ds["MASK"])
            rec["nvis"] += int(mask.size)
            t0 = time.perf_counter()
            host = compute_counts_host(uvw, freq, mask, nx, nx, cell, cell,
                                       k=k)
            rec["t_host"] += time.perf_counter() - t0
            sync(device)
            t0 = time.perf_counter()
            card, peak = _peak_gb(device, lambda: compute_counts(
                uvw, freq, mask, nx, nx, cell, cell, k=k, device=device))
            rec["t_card"] += time.perf_counter() - t0
            rec["peak_gb"] = max(rec["peak_gb"], peak)
            rec["dtype"] = str(card.dtype)
            host_t = torch.as_tensor(host, device=device)
            diff = (card - host_t).abs()
            rec["rel_err"] = max(rec["rel_err"], float(
                diff.max() / host_t.abs().max()))
            rec["cells_differ"] += int((diff > 0).sum())
            rec["occupancy_differs"] += int(((card != 0) !=
                                             (host_t != 0)).sum())
            uvw_t = torch.as_tensor(uvw, device=device)
            freq_t = torch.as_tensor(freq, device=device)
            wc, wh = (counts_to_weights(c, uvw_t, freq_t, nx, nx, cell, cell,
                                        0.0) for c in (card, host_t))
            rec["weights_rel_err"] = max(rec["weights_rel_err"], float(
                (wc - wh).abs().max() / wh.abs().max()))
        out["counts"][k] = rec
    # (b) hessian_psf_slice on each band against hessian_psf_cube's band
    psf = torch.as_tensor(inp["psf"], device=device)
    nb = psf.shape[0]
    wsum = float(np.sum(inp["wsums"]))
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(nb, nx, nx, device=device, dtype=psf.dtype, generator=g)
    psfhat = make_psfhat(psf)
    sync(device)
    t0 = time.perf_counter()
    cube = hessian_psf_cube(x, psfhat, sigmainv=1e-4, wsum=wsum)
    sync(device)
    out["t_cube"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    err = 0.0
    for b in range(nb):
        sl = hessian_psf_slice(x[b], psfhat[b], sigmainv=1e-4, wsum=wsum)
        err = max(err, float((sl - cube[b]).abs().max()
                             / cube[b].abs().max()))
    sync(device)
    out["t_slices"] = time.perf_counter() - t0
    out["slice_rel_err"] = err
    out["psf_shape"] = list(psf.shape)
    del x, cube, sl, psfhat
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # (c) make_psfhat in chunks of 2 bands against the whole cube
    ph0, out["psfhat_peak_gb"] = _peak_gb(device, lambda: make_psfhat(psf))
    ph2, out["psfhat_chunked_peak_gb"] = _peak_gb(
        device, lambda: make_psfhat(psf, band_chunk=2))
    out["psfhat_rel_err"] = float((ph2 - ph0).abs().max()
                                  / ph0.abs().max())
    del ph0, ph2, psf
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # (d) dual_update_21 in float32 on the card against float64 on the CPU,
    # on coefficients of the SARA transform's shape, some all zero
    psi = make_psi(nx, nx, tuple(spot["bases"].split(",")), spot["nlevels"])
    shape = (nb, len(spot["bases"].split(",")), psi.Nymax, psi.Nxmax)
    rng = np.random.default_rng(seed)
    vp = rng.standard_normal(shape, dtype=np.float32)
    v = rng.standard_normal(shape, dtype=np.float32)
    w = rng.random(shape[1:], dtype=np.float32) + 0.5
    vp[:, 0, :16] = v[:, 0, :16] = 0.0
    lam, sigma = 5.0, 1.7
    ref = dual_update_21(*(torch.as_tensor(a, dtype=torch.float64)
                           for a in (vp, v)), lam, sigma=sigma,
                         weight=torch.as_tensor(w, dtype=torch.float64))
    t0 = time.perf_counter()
    got = dual_update_21(*(torch.as_tensor(a, device=device)
                           for a in (vp, v)), lam, sigma=sigma,
                         weight=torch.as_tensor(w, device=device))
    sync(device)
    out["t_dual"] = time.perf_counter() - t0
    out["dual_shape"] = list(shape)
    out["dual_rel_err"] = float((got.cpu().double() - ref).abs().max()
                                / ref.abs().max())
    out["dual_zero_kept"] = bool((got[:, 0, :16] == 0).all())
    return out


def report_api(r35, t35):
    """Print phase 35's records and gate them."""
    for k, rec in r35["counts"].items():
        print(f"[api] compute_counts k={k} ({rec['dtype']}), "
              f"{rec['nvis']} visibilities in {rec['datasets']} datasets: "
              f"card {rec['t_card']:.3f} s (peak +{rec['peak_gb']:.3f} GiB), "
              f"host builder {rec['t_host']:.3f} s; "
              f"max|card - host|/max = {rec['rel_err']:.3e} (bound "
              f"{CNTOL}), cells differing at all {rec['cells_differ']}, "
              f"occupied on one side only {rec['occupancy_differs']}; "
              f"counts_to_weights(robust=0) {rec['weights_rel_err']:.3e} "
              f"(bound {CNTOL})")
    print(f"[api] hessian_psf_slice on each band of the {r35['psf_shape']} "
          f"PSF vs hessian_psf_cube's band: max|diff|/max = "
          f"{r35['slice_rel_err']:.3e} (bound {TOL}); slices "
          f"{r35['t_slices']:.3f} s, cube {r35['t_cube']:.3f} s")
    print(f"[api] make_psfhat(band_chunk=2) vs band_chunk=None: "
          f"{r35['psfhat_rel_err']:.3e} (bound {PHTOL}); peak above the "
          f"PSF {r35['psfhat_chunked_peak_gb']:.3f} GiB against "
          f"{r35['psfhat_peak_gb']:.3f} GiB")
    print(f"[api] dual_update_21 float32 on the card vs float64 on the CPU, "
          f"{r35['dual_shape']}: {r35['dual_rel_err']:.3e} (bound {PHTOL}), "
          f"zero coefficients kept {r35['dual_zero_kept']}; card "
          f"{r35['t_dual']:.3f} s")
    print(f"[api] phase 35 {t35:.1f} s")
    for k, rec in r35["counts"].items():
        need(rec["rel_err"] <= CNTOL, f"compute_counts k={k} card vs host "
             f"{rec['rel_err']} > {CNTOL}")
        need(rec["weights_rel_err"] <= CNTOL, f"counts_to_weights k={k} "
             f"card vs host {rec['weights_rel_err']} > {CNTOL}")
        need(rec["dtype"] == "torch.float64", f"compute_counts k={k} on "
             f"float64 uvw gave {rec['dtype']}")
    need(r35["slice_rel_err"] <= TOL, f"hessian_psf_slice vs the cube's "
         f"band {r35['slice_rel_err']} > {TOL}")
    need(r35["psfhat_rel_err"] <= PHTOL, f"make_psfhat chunked vs whole "
         f"{r35['psfhat_rel_err']} > {PHTOL}")
    need(r35["dual_rel_err"] <= PHTOL and r35["dual_zero_kept"],
         f"dual_update_21 card vs float64 {r35['dual_rel_err']}, zero "
         f"coefficients kept {r35['dual_zero_kept']}")


def main():
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    if not (root / "pfb_tpu_torch" / "__init__.py").exists():
        print("FAIL: pfb_tpu_torch is not beside chip_smoke.py",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    device = torch.device("cuda")

    try:
        # 1. device
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        smi_line = smi[0] if smi else "nvidia-smi: no output"
        print(smi_line)
        print(f"[device] {torch.cuda.get_device_name(0)} x "
              f"{torch.cuda.device_count()}; torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

        # 2. build
        from pfb_tpu_torch import kernels, native
        t0 = time.perf_counter()
        kernels.library()
        print(f"[build] {time.perf_counter() - t0:.1f} s "
              f"(nvcc {kernels.build_seconds()} s, by source "
              f"{json.dumps(kernels.source_seconds())}); plan builder: "
              f"{native.builder()}")

        # 3. wgrid path
        workdir = root / "build" / "chip_smoke"
        workdir.mkdir(parents=True, exist_ok=True)
        truth = simulate(workdir)
        print(f"[main] simulate {truth['t_simulate']:.3f} s (host)")
        res = main_path(truth, device)
        nw_img, nw_psf = wgrid_planes(res["dds"], NX, GRID["epsilon"])
        print(f"[main] {truth['nvis']} visibilities, image {NX}^2 x "
              f"{len(res['dds'])} bands, PSF {2 * NX}^2; w planes: image "
              f"{nw_img}, PSF {nw_psf}")
        srcs = report_path("main", res, truth, NX)
        launches = {k: res["launches"]["grid"][k]
                    + res["launches"]["spotless"][k] for k in counters()}

        # 4. kernel vs plain (K1, K3)
        recs = kernel_checks(res["dds"], NX, nw_img, nw_psf, device)
        for r in recs:
            print("[kernel] " + json.dumps(r))

        # 5. checks of the wgrid path
        lw = res["launches"]
        need(lw["spotless"]["K1"] > 0, "K1 never launched on the main path")
        for k in ("K3r", "K3c"):
            need(lw["grid"][k] > 0, f"{k} never launched inside _grid")
            need(lw["spotless"][k] > 0, f"{k} never launched inside "
                 "_spotless")
        del res, srcs
        torch.cuda.empty_cache()

        # 6. pg path
        rpg = main_path(truth, device, grid=GRID_PG, spot=SPOT_PG)
        report_path("pg", rpg, truth, NX)
        for k in launches:
            launches[k] += rpg["launches"]["grid"][k] + \
                rpg["launches"]["spotless"][k]
        lp = rpg["launches"]
        t6, p6 = dict(rpg["t"]), dict(rpg.get("peak_gb", {}))

        # 7. kernel vs plain (K4, K5, K6), pg against wgrid
        pg_recs, plans = pg_kernel_checks(rpg, NX, GRID_PG["epsilon"],
                                          device)
        for name, p in zip(("image", "PSF"), plans):
            print(f"[pg] {name} plan " + json.dumps(plan_summary(p)))
        del plans
        for r in pg_recs:
            print("[kernel] " + json.dumps(r))
        recs += pg_recs
        xerr = pg_cross_check(rpg, NX, GRID_PG["epsilon"], device)
        print(f"[pg] dirty image pg vs wgrid (dataset 0, same weights): "
              f"max|diff|/max|wgrid| = {xerr:.3e} (bound {XTOL})")

        # 8. checks
        for k in ("K3c", "K3r", "K4", "K5"):
            need(lp["grid"][k] > 0, f"{k} never launched inside pg _grid")
            need(lp["spotless"][k] > 0,
                 f"{k} never launched inside pg _spotless")
        need(lp["spotless"]["K6"] > 0, "K6 never launched inside _spotless")
        need(xerr <= XTOL, f"pg vs wgrid dirty {xerr} > {XTOL}")

        # 9. klean path (the pg path's xds and dds reused)
        print("[klean] reuses the pg path's xds and copies of its dds")
        rkl = klean_path(rpg, device)
        report_klean(rkl, truth, NX)
        lk = rkl["launches"]["klean"]
        for k in launches:
            launches[k] += lk[k]

        # 27. the post-deconvolution path on the klean path's products
        rpost = post_path(rkl, rpg, truth, device, workdir)
        report_post(rpost, truth)
        for lc in rpost["launches"].values():
            for k in launches:
                launches[k] += lc[k]
        mds = rpost["mds"]
        del rkl, rpost
        torch.cuda.empty_cache()

        # 28. fwdbwd, fastim and smoovie on the pg path's products
        rim = imaging_path(rpg, mds, truth, device, workdir)
        report_imaging(rim)
        for lc in rim["launches"].values():
            for k in launches:
                launches[k] += lc[k]
        del rim, mds
        torch.cuda.empty_cache()

        # 29. the CLI path: phase 6's recipe through the pipeline command
        rcli = cli_path(truth, rpg, device, workdir)
        report_cli(rcli, lp)
        for lc in rcli["launches"].values():
            for k in launches:
                launches[k] += lc[k]
        torch.cuda.empty_cache()

        # 30. two processes on the card, on phase 29's dds store
        rmesh = mesh_procs(rcli["store"], NX, device, workdir)
        report_mesh(rmesh)
        del rcli, rmesh
        torch.cuda.empty_cache()

        # 31. backend "mm" on the pg path's xds, and the joint solve
        rmm = mm_path(rpg, device)
        report_mm(rmm)
        l31 = rmm["launches"]
        for lc in l31.values():
            for k in launches:
                launches[k] += lc[k]
        del rmm
        torch.cuda.empty_cache()

        # 10. blocked against unblocked, K7-K9 against plain (2048^2)
        berr, bsum, gs_recs = blocked_checks(rpg, NX, device)
        print("[blocked] klean path's blocked plan (dataset 0) "
              + json.dumps(bsum))
        print(f"[blocked] residual operator plane_block="
              f"{KLEAN['plane_block']} vs all planes (dataset 0, pg model):"
              f" max|diff|/max = {berr:.3e} (bound {BTOL})")
        for r in gs_recs:
            print("[kernel] " + json.dumps(r))
        recs += gs_recs
        # kept for phase 14: the 2048^2 grid phase's PSF cube, its band
        # weights and the pg path's model; for phases 15-19 the pg path's
        # datasets, dataset 0's visibilities, model and hessnorm; for
        # phase 35 the datasets, the cell, the PSF cube and band weights
        from pfb_tpu_torch.workers.cubes import dds2cubes
        cubes = dds2cubes(rpg["dds"], len(rpg["dds"]))
        k2_in = dict(psf=cubes[3], wsums=cubes[6], model=rpg["model"])
        api_in = api_inputs(rpg, cubes)
        dist_in = dict(dds=rpg["dds"], xds=rpg["xds"][:1], psf=cubes[3],
                       model=rpg["model"], dirty_rms=rpg["dirty_rms"],
                       hessnorm=rpg["stats"]["hessnorm"])
        del rpg, cubes
        torch.cuda.empty_cache()

        # 11. the blocked engine at the flagship size
        fl, fl_recs = flagship(device)
        for label in ("blocked", "all planes"):
            print(f"[flagship] {label} " + json.dumps(fl[label]))
        print(f"[flagship] blocked vs all planes: adjoint "
              f"{fl['adjoint_rel_diff']:.3e}, Hessian "
              f"{fl['hessian_rel_diff']:.3e} (bound {BTOL})")
        for r in fl_recs:
            print("[kernel] " + json.dumps(r))
        recs += fl_recs
        for label in ("blocked", "all planes"):
            for k in launches:
                launches[k] += fl[label]["launches"][k]
        for k in ("K3c", "K3r", "K7", "K8", "K9"):
            need(fl["blocked"]["launches"][k] > 0,
                 f"{k} never launched in the flagship blocked operator")
        torch.cuda.empty_cache()

        # 12. K11 path: 3072^2, the general PSF kernel in spotless
        truth12 = simulate(workdir, nx=NX_K11, srf=3.0)
        print(f"[k11] simulate {truth12['t_simulate']:.3f} s (host), cell "
              f"{truth12['cell_rad']:.6e} rad")
        r12 = main_path(truth12, device, grid=GRID_K11, spot=SPOT_PG)
        report_path("k11", r12, truth12, NX_K11)
        l12 = r12["launches"]
        for k in launches:
            launches[k] += l12["grid"][k] + l12["spotless"][k]
        st12 = r12["stats"]
        print(f"[k11] engine {st12['engine']}, pd solver "
              f"{st12['pd_solver']}")

        # 13. K11 against plain
        k11_recs, (NX12, NY12) = k11_kernel_checks(r12["dds"], NX_K11,
                                                   device)
        print(f"[k11] PSF {NX12}x{NY12} (v3 needs psf = 2 x image with "
              "N1 % N2 == 0 in NX's factors)")
        for r in k11_recs:
            print("[kernel] " + json.dumps(r))
        recs += k11_recs
        del r12, truth12
        torch.cuda.empty_cache()

        # 14. K2 path: CG-fused PCG
        cerr, k2_recs, rates, l14, k2_info = k2_checks(device=device,
                                                       **k2_in)
        del k2_in
        print(f"[pcg] CG-fused (K2) vs pcg_bands (K1), 2048^2 grid PSF, 25 "
              f"iterations: max|diff|/max = {cerr:.3e} (bound {CTOL})")
        for tag, info in k2_info.items():
            print(f"[pcg] K2 {tag}: " + json.dumps(info))
        print(f"[pcg] {PCG['nx']}^2 x {PCG['nband']}, {PCG['niter']} "
              "iterations, it/s " + json.dumps(rates))
        print("[pcg] launches " + json.dumps(l14))
        for r in k2_recs:
            print("[kernel] " + json.dumps(r))
        recs += k2_recs
        for k in launches:
            launches[k] += l14[k]

        # 15. K10 against plain at the dist path's shapes
        k10_recs = k10_checks(dist_in["psf"], NX, NSPACE, device)
        for r in k10_recs:
            print("[kernel] " + json.dumps(r))
        recs += k10_recs
        torch.cuda.empty_cache()

        # 16. the space-sharded matvec (K10 + all-to-alls) against K1
        sm = space_matvec_check(dist_in["psf"], NX, NSPACE, device)
        print(f"[space] hessian_psf_space_dist(pallas) on a (2, {NSPACE}) "
              f"virtual mesh vs K1, (8, {NX}^2), grid PSF: " + json.dumps(sm)
              + f" (bound {STOL} of max)")
        torch.cuda.empty_cache()

        # 17. dist path: _spotless_dist on a (2, 4) virtual mesh
        print("[dist] reuses the pg path's xds and dds (init and grid not "
              "rerun) and its hessnorm")
        rd = dist_path(dist_in["dds"], dist_in["hessnorm"], device)
        rd["dirty_rms"] = dist_in["dirty_rms"]
        report_path("dist", rd, truth, NX)
        ld = rd["launches"]["spotless_dist"]
        for k in launches:
            launches[k] += ld[k]
        std = rd["stats"]
        derr = float(abs(rd["model"] - dist_in["model"]).max()
                     / abs(dist_in["model"]).max())
        print(f"[dist] engine {std['engine']}, pd engine "
              f"{std['pd_engine']}, psi {std['psi_method']}; model vs the "
              f"pg path's _spotless: max|diff|/max = {derr:.3e} (bound "
              f"{DTOL})")
        del rd
        torch.cuda.empty_cache()

        # 18. row-sharded adjoint against the one-device pg dirty image
        rerr, rsec, lr = rowdist_check(dist_in, NX, GRID_PG["epsilon"],
                                       device)
        print(f"[rowdist] make_vis2dirty_rowdist on a (1, 4) virtual mesh "
              f"vs the pg dirty image (dataset 0): max|diff|/max = "
              f"{rerr:.3e} (bound {TOL}), {rsec:.3f} s with plans; "
              f"launches " + json.dumps(lr))
        for k in launches:
            launches[k] += lr[k]

        # 19. band-sharded blocked residual against all planes
        bderr, lbd = blocked_dist_check(dist_in, NX, device)
        print(f"[blocked-dist] make_hessian_dds_dist plane_block="
              f"{KLEAN['plane_block']} vs all planes, (2, 1) virtual mesh, "
              f"pg model: max|diff|/max = {bderr:.3e} (bound {BTOL}); "
              "launches " + json.dumps(lbd))
        for lab in lbd:
            for k in launches:
                launches[k] += lbd[lab][k]
        del dist_in
        torch.cuda.empty_cache()

        # 20. K12, K13, K14: one band of 4096^2 in 8192^2
        sb_recs, cross, l20 = single_band_checks(device)
        print("[single-band] launches " + json.dumps(l20))
        print("[single-band] max|diff|/max between the entry points "
              + json.dumps(cross) + f" (bound {TOL})")
        for r in sb_recs:
            print("[kernel] " + json.dumps(r))
        recs += sb_recs
        for k in launches:
            launches[k] += l20[k]
        torch.cuda.empty_cache()

        # 21. K15 at (8, 4096^2)
        k15_recs, rt_err, l21 = k15_checks(device)
        print(f"[k15] v3_cols_inv(v3_cols_fwd(x)) vs x: max|diff|/max = "
              f"{rt_err:.3e} (bound {TOL}); launches " + json.dumps(l21))
        for r in k15_recs:
            print("[kernel] " + json.dumps(r))
        recs += k15_recs
        for k in launches:
            launches[k] += l21[k]
        torch.cuda.empty_cache()

        # 22. L2: the x-pass lab's kernels at (4, 8192^2)
        l2_recs, split64, l22 = l2_checks(device)
        print("[l2] launches " + json.dumps(l22))
        print(f"[l2] split x pass vs float64 transform: max|diff|/max = "
              f"{split64:.3e} (printed, not gated)")
        for r in l2_recs:
            print("[kernel] " + json.dumps(r))
        recs += l2_recs
        for k in launches:
            launches[k] += l22[k]

        # 23. L3: the capacity lab on its observation
        l3_recs, sweep, l23 = l3_checks(device)
        print("[l3] launches " + json.dumps(l23))
        print("[l3] _spread_fold by capacity " + json.dumps(sweep))
        for r in l3_recs:
            print("[kernel] " + json.dumps(r))
        recs += l3_recs
        for k in launches:
            launches[k] += l23[k]
        launches["L3"] = l23["K4"]

        # 24. the cluster column kernels at the paths' shapes
        cols_recs = cols_checks(device)
        for r in cols_recs:
            print("[kernel] " + json.dumps(r))
        recs += cols_recs

        # 25. the rows stage's register kernel at the paths' shapes, L1
        rows_recs, three, l25 = rows_checks(device)
        for name, ms in three.items():
            print(f"[rows] {name}: as three torch.fft calls (fft, product, "
                  f"ifft; context, not a one-call library) {ms:.4f} ms")
        print("[rows] L1 launches " + json.dumps(l25))
        for r in rows_recs:
            print("[kernel] " + json.dumps(r))
        recs += rows_recs
        launches["L1"] = l25["K10br"]

        # 26. the 1024^2 pg path: its 2048^2 and 4096^2 grids and its
        # 2048^2 PSF on the cluster column and register row kernels
        truth26 = simulate(workdir, nx=NX_SMALL)
        print(f"[1024] simulate {truth26['t_simulate']:.3f} s (host), cell "
              f"{truth26['cell_rad']:.6e} rad, {truth26['nvis']} "
              "visibilities")
        r26 = main_path(truth26, device, grid=GRID_SMALL, spot=SPOT_PG)
        report_path("1024", r26, truth26, NX_SMALL)
        l26 = r26["launches"]
        t26, p26 = dict(r26["t"]), dict(r26.get("peak_gb", {}))
        for k in l26["grid"]:
            launches[k] += l26["grid"][k] + l26["spotless"][k]
        cubes26 = dds2cubes(r26["dds"], len(r26["dds"]))
        k2_in26 = dict(psf=cubes26[3], wsums=cubes26[6], model=r26["model"])
        del r26, truth26, cubes26
        torch.cuda.empty_cache()
        small_recs = small_kernel_checks(k2_in26["psf"], NX_SMALL, device)
        cerr26, k2_recs26, _, _, k2_info26 = k2_checks(device=device,
                                                       pcg=None, **k2_in26)
        del k2_in26
        print(f"[1024] CG-fused (K2) vs pcg_bands (K1), {2 * NX_SMALL}^2 "
              f"grid PSF, 25 iterations: max|diff|/max = {cerr26:.3e} "
              f"(bound {CTOL})")
        for tag, info in k2_info26.items():
            print(f"[1024] K2 {tag}: " + json.dumps(info))
        for r in small_recs + k2_recs26:
            print("[kernel] " + json.dumps(r))
        recs += small_recs + k2_recs26
        torch.cuda.empty_cache()

        # 32. (a) the 1920^2 pg path: K11, rows at R2 = 15 and 30
        truth32 = simulate(workdir, nx=NX_1920)
        print(f"[1920] simulate {truth32['t_simulate']:.3f} s (host), cell "
              f"{truth32['cell_rad']:.6e} rad, {truth32['nvis']} "
              "visibilities")
        r32 = main_path(truth32, device, grid=GRID_1920, spot=SPOT_PG)
        report_path("1920", r32, truth32, NX_1920)
        l32, st32 = r32["launches"], r32["stats"]
        for k in l32["grid"]:
            launches[k] += l32["grid"][k] + l32["spotless"][k]
        print("[1920] seconds and peak GiB by stage against the 2048^2 pg "
              "path's (phase 6, this call): " + json.dumps({
                  stage: {"1920": [round(r32["t"][stage], 3),
                                   round(r32["peak_gb"].get(stage, 0), 3)],
                          "2048": [round(t6[stage], 3),
                                   round(p6.get(stage, 0), 3)]}
                  for stage in ("init", "grid", "spotless")}))
        print(f"[1920] engine {st32['engine']}, pd solver "
              f"{st32['pd_solver']}")
        del r32, truth32
        torch.cuda.empty_cache()
        # (b) the register row kernels at R2 = 9-64, the four-step, K3xl
        # and K3yl
        t0 = time.perf_counter()
        long_recs = long_kernel_checks(device)
        for r in long_recs:
            print("[kernel] " + json.dumps(r))
        print(f"[long] {len(long_recs)} records in "
              f"{time.perf_counter() - t0:.1f} s")
        recs += long_recs
        torch.cuda.empty_cache()
        # (c) the grid worker at 4608^2: its PSF grid on the four-step
        r32c = four_step_path(workdir, device)
        l32c = r32c["launches"]
        for k in l32c:
            launches[k] += l32c[k]
        print(f"[4608] _grid(pg, no w) {r32c['nds']} datasets, PSF "
              f"{r32c['psf_shape']}: {r32c['t']:.3f} s, peak "
              f"{r32c.get('peak_gb', 0.0):.2f} GiB; vs its plain versions "
              + json.dumps(r32c["rel_err"]) + f" (bound {TOL}); launches "
              + json.dumps({k: v for k, v in l32c.items() if v}))
        torch.cuda.empty_cache()

        # 33. (a), (b) the 512^2 and 768^2 pg paths on the short designs
        r33 = {}
        for n in NX_SHORT:
            r33[n] = short_path(workdir, device, n)
            for k in r33[n]["launches"]["grid"]:
                launches[k] += r33[n]["launches"]["grid"][k] + \
                    r33[n]["launches"]["spotless"][k]
            st = r33[n]["stats"]
            print(f"[{n}] engine {st['engine']}, pd solver "
                  f"{st['pd_solver']}, v3 {r33[n]['v3']}")
            if r33[n]["v3"]:
                print(f"[{n}] CG-fused (K2) vs pcg_bands (K1), {2 * n}^2 "
                      f"grid PSF, 25 iterations: max|diff|/max = "
                      f"{r33[n]['cerr']:.3e} (bound {CTOL})")
            for tag, info in r33[n]["k2_info"].items():
                print(f"[{n}] K2 {tag}: " + json.dumps(info))
            for r in r33[n]["k2_recs"]:
                print("[kernel] " + json.dumps(r))
            recs += r33[n]["k2_recs"]
        print("[short] seconds and peak GiB by stage against the 1024^2 pg "
              "path's (phase 26, this call): " + json.dumps({
                  stage: {**{str(n): [round(q["t"][stage], 3),
                                      round(q["peak_gb"].get(stage, 0), 3)]
                             for n, q in r33.items()},
                          "1024": [round(t26[stage], 3),
                                   round(p26.get(stage, 0), 3)]}
                  for stage in ("init", "grid", "spotless")}))
        # (c) the short designs at every short length, beside the line
        # kernels they replace
        short_recs = short_kernel_checks(device)
        for r in short_recs:
            print("[kernel] " + json.dumps(r))
        recs += short_recs
        torch.cuda.empty_cache()

        # 34. the grid worker's w-gridded PSF at 4608^2 on K3xl and K3yl
        t0 = time.perf_counter()
        r34 = wgrid_psf_path(workdir, device)
        t34 = time.perf_counter() - t0
        l34, l34e = r34["launches"], r34["launches_earlier"]
        for k in l34:
            launches[k] += l34[k]
        print(f"[{NX_W}w] simulate {r34['t_simulate']:.3f} s (host), init "
              f"{r34['t_init']:.3f} s; _grid(pg, w-gridded) "
              f"{r34['nds']} bands: {r34['t_grid']:.3f} s, peak "
              f"{r34.get('peak_gb', 0.0):.2f} GiB; on the earlier route "
              f"(K3f, then K3c) {r34['t_grid_earlier']:.3f} s, peak "
              f"{r34.get('peak_gb_earlier', 0.0):.2f} GiB, products "
              + json.dumps(r34["earlier_rel_err"]) + "; on the plain "
              f"versions {r34['t_grid_plain']:.3f} s, peak "
              f"{r34.get('peak_gb_plain', 0.0):.2f} GiB; this call vs "
              "plain " + json.dumps(r34["rel_err"]) + f" (bound {TOL}); "
              "launches " + json.dumps({k: v for k, v in l34.items() if v})
              + ", earlier route's " + json.dumps(
                  {k: v for k, v in l34e.items() if v})
              + f"; the phase {t34:.1f} s")

        # 35. the JAX package's last public functions on the pg path's data
        t0 = time.perf_counter()
        r35 = api_path(api_in, device)
        del api_in
        report_api(r35, time.perf_counter() - t0)
        torch.cuda.empty_cache()

        # 36. S1 / S2, the SARA analysis and synthesis kernels
        sara_recs = sara_checks(device)
        for r in sara_recs:
            print("[sara] " + json.dumps(r))
        recs += sara_recs
        for tag, lc in (("wgrid _spotless", lw["spotless"]),
                        ("pg _spotless", lp["spotless"])):
            for k in ("S1", "S2"):
                need(lc[k] > 0, f"{k} never launched inside {tag}")

        # every rows stage of the PSF paths at NY = 4096, 6144 and 8192
        # took the register kernel (none took psf_rows_kernel)
        for tag, lc in (("wgrid _spotless", lw["spotless"]),
                        ("pg _spotless", lp["spotless"]),
                        ("_spotless_dist", ld),
                        ("3072^2 _spotless", l12["spotless"]),
                        ("the PCG phase", l14), ("the single-band phase", l20),
                        ("the L1 lab's run", l25),
                        ("1024^2 _spotless", l26["spotless"]),
                        ("1920^2 _spotless", l32["spotless"])):
            need(lc["K10br"] > 0, f"K10br never launched inside {tag}")
            need(lc["K10br"] == rows_stages(lc) and lc["rows_line"] == 0,
                 f"{tag}: {rows_stages(lc)} rows stages, {lc['K10br']} on "
                 f"K10br, {lc['rows_line']} on psf_rows_kernel")

        # the cluster column kernels ran inside the PSF paths, the PSF
        # column stages' line kernels never
        for tag, lc in (("wgrid _spotless", lw["spotless"]),
                        ("pg _spotless", lp["spotless"]),
                        ("_spotless_dist", ld),
                        ("3072^2 _spotless", l12["spotless"]),
                        ("1024^2 _spotless", l26["spotless"]),
                        ("1920^2 _spotless", l32["spotless"])):
            for k in ("K10ac", "K10cc"):
                need(lc[k] > 0, f"{k} never launched inside {tag}")
            need(lc["cols_line"] == 0, f"a PSF column stage inside {tag} "
                 "launched a line kernel")

        # checks of phase 26: every transform of the 1024^2 path on the
        # cluster and register routes, none on the line kernels
        for stage in ("grid", "spotless"):
            for k in ("K3c", "K3r"):
                need(l26[stage][k] > 0,
                     f"{k} never launched inside the 1024^2 _{stage}")
            for k in ("K3", "cols_line", "rows_line"):
                need(l26[stage][k] == 0,
                     f"{k} launched inside the 1024^2 _{stage}")
        for k in ("K1", "K10ac", "K10cc", "K10br"):
            need(l26["spotless"][k] > 0,
                 f"{k} never launched inside the 1024^2 _spotless")
        need(l26["spotless"]["K11"] == 0, "K11 launched inside the 1024^2 "
             "_spotless: v3 holds there")
        need(cerr26 <= CTOL, f"1024^2 CG-fused vs pcg_bands {cerr26} > "
             f"{CTOL}")
        for tag, info in k2_info26.items():
            need(info["columns"].startswith("cluster") and
                 info["rows"] == "K10br", f"K2 {tag} is off the routes: "
                 f"{info}")
            need(info["conv_bitwise_k1_of_p"], f"K2 {tag}: conv is not "
                 "K1's of its own p bit for bit")
            need(info["reruns_bitwise"], f"K2 {tag}: reruns differ")

        # checks of phase 32: the 1920^2 path on the register row kernels
        # (R2 = 15 and 30) and K11, no line kernel inside grid or spotless
        for stage in ("grid", "spotless"):
            for k in ("K3c", "K3r", "K4", "K5"):
                need(l32[stage][k] > 0,
                     f"{k} never launched inside the 1920^2 _{stage}")
            for k in ("K3", "cols_line", "rows_line", "K3f"):
                need(l32[stage][k] == 0,
                     f"{k} launched inside the 1920^2 _{stage}")
        for k in ("K6", "K10ac", "K10cc", "K10br", "K11"):
            need(l32["spotless"][k] > 0,
                 f"{k} never launched inside the 1920^2 _spotless")
        for k in ("K1", "K2"):
            need(l32["spotless"][k] == 0, f"{k} launched inside the 1920^2 "
                 "_spotless: v3 does not hold there")
        need(st32["pd_solver"] == "primal_dual_hostloop",
             f"1920^2 spotless ran {st32['pd_solver']}")
        for prefix in ("K3f ", "four-step route "):
            n = sum(r["name"].startswith(prefix) for r in long_recs)
            need(n == 2 * len(FOUR_LENGTHS), f"{prefix}records {n}")
        for prefix in ("K3xl ", "K3yl ", "K3cl ", "K3fr "):
            n = sum(r["name"].startswith(prefix) for r in long_recs)
            need(n == 2 * len(FOUR_LENGTHS), f"{prefix}records {n}")
        need(l32c["K3xl"] == l32c["K3yl"] == r32c["nds"] and
             l32c["K3f"] == 0 and l32c["K3"] == 0,
             f"the 4608^2 grid's PSF passes: K3xl {l32c['K3xl']}, K3yl "
             f"{l32c['K3yl']}, K3f {l32c['K3f']}, K3 {l32c['K3']} for "
             f"{r32c['nds']} datasets")
        bad = {k: v for k, v in r32c["rel_err"].items() if not v <= TOL}
        need(not bad, f"the 4608^2 grid against its plain versions: {bad}")

        # checks of phase 34: both passes of every PSF w plane on K3xl and
        # K3yl, none on the four-step or the line kernel
        for k in ("K3xl", "K3yl", "K4", "K5"):
            need(l34[k] > 0, f"{k} never launched inside the {NX_W}^2 "
                 "w-gridded _grid")
        for k in ("K3f", "K3"):
            need(l34[k] == 0, f"{k} launched inside the {NX_W}^2 "
                 "w-gridded _grid")
        need(l34["K3xl"] == l34["K3yl"] >= r34["nds"], f"the {NX_W}^2 "
             f"w-gridded PSF: K3xl {l34['K3xl']}, K3yl {l34['K3yl']} for "
             f"{r34['nds']} bands, w planes {r34['nw']} (4 a transform)")
        need(l34e["K3f"] == 2 * l34["K3xl"] and l34e["K3xl"] ==
             l34e["K3yl"] == 0, f"the earlier route's launches {l34e}")
        bad = {k: v for k, v in r34["rel_err"].items() if not v <= TOL}
        need(not bad, f"the {NX_W}^2 w-gridded grid against its plain "
             f"versions: {bad}")
        bad = {k: v for k, v in r34["earlier_rel_err"].items()
               if not v <= TOL}
        need(not bad, f"the {NX_W}^2 w-gridded grid against the earlier "
             f"route: {bad}")

        # checks of phase 33: the 512^2 and 768^2 paths on the short
        # designs, no line kernel inside grid or spotless
        for n, q in r33.items():
            lq = q["launches"]
            for stage in ("grid", "spotless"):
                for k in ("K3c", "K3r", "K4", "K5"):
                    need(lq[stage][k] > 0,
                         f"{k} never launched inside the {n}^2 _{stage}")
                for k in ("K3", "cols_line", "rows_line", "K3f"):
                    need(lq[stage][k] == 0,
                         f"{k} launched inside the {n}^2 _{stage}")
            psfk = "K1" if q["v3"] else "K11"
            for k in (psfk, "K6", "K10ac", "K10cc", "K10br"):
                need(lq["spotless"][k] > 0,
                     f"{k} never launched inside the {n}^2 _spotless")
            for k in (("K11",) if q["v3"] else ("K1", "K2")):
                need(lq["spotless"][k] == 0, f"{k} launched inside the "
                     f"{n}^2 _spotless (v3 {q['v3']})")
            need(q["v3"] or q["stats"]["pd_solver"] ==
                 "primal_dual_hostloop", f"{n}^2 spotless ran "
                 f"{q['stats']['pd_solver']}")
            need(lq["spotless"]["K10br"] == rows_stages(lq["spotless"]),
                 f"the {n}^2 _spotless: {rows_stages(lq['spotless'])} rows "
                 f"stages, {lq['spotless']['K10br']} on K10br")
            need(not q["v3"] or q["cerr"] <= CTOL, f"{n}^2 CG-fused vs "
                 f"pcg_bands {q['cerr']} > {CTOL}")
            for tag, info in q["k2_info"].items():
                need(info["columns"].startswith("cluster") and
                     info["rows"] == "K10br", f"K2 {tag} is off the routes: "
                     f"{info}")
                need(info["conv_bitwise_k1_of_p"], f"K2 {tag}: conv is not "
                     "K1's of its own p bit for bit")
                need(info["reruns_bitwise"], f"K2 {tag}: reruns differ")
        need(r33[NX_SHORT[0]]["v3"] and r33[NX_SHORT[0]]["k2_info"],
             f"no K2 check at {NX_SHORT[0]}^2")
        for N in SHORT_LENGTHS:
            for prefix in ("K3c x pass", "K3r y pass"):
                n = sum(r["name"].startswith(prefix) and f", {N}^2)" in
                        r["name"] for r in short_recs)
                need(n == 2, f"{prefix} records at {N}: {n}")

        # checks of phases 22-23
        for k in ("L2a", "L2b", "L2c", "K3", "K3c"):
            need(l22[k] > 0, f"{k} never launched in the L2 lab's run")
        need(l23["K4"] > 0 and l23["K5"] > 0,
             "K4/K5 never launched in the L3 lab's run")
        bad = {c: v for c, v in sweep["capacity_rel_diff"].items()
               if not v <= TOL}
        need(not bad, f"_spread_fold grids differ across capacities: {bad}")

        # checks of phases 20-21
        for k in ("K12", "K13", "K14"):
            need(l20[k] > 0, f"{k} never launched by its entry point")
        for k in ("K15a", "K15b"):
            need(l21[k] > 0, f"{k} never launched by its entry point")
        bad = {k: v for k, v in cross.items() if not v <= TOL}
        need(not bad, f"single-band entry points disagree: {bad}")
        need(rt_err <= TOL, f"K15 round trip {rt_err} > {TOL}")

        # checks of phases 15-19
        need(sm["rel_err"] <= STOL, f"space matvec vs K1 {sm['rel_err']}")
        need(sm["bitwise"], "space matvec not bitwise equal to K1")
        need(std["pd_engine"] == "pallas" and std["psi_method"] == "halo",
             f"dist path ran pd engine {std['pd_engine']}, psi "
             f"{std['psi_method']}")
        for k in ("K10a", "K10b", "K10c", "K1"):
            need(ld[k] > 0, f"{k} never launched inside _spotless_dist")
        for k in ("K11", "K2"):
            need(ld[k] == 0, f"{k} launched inside _spotless_dist")
        need(ld["K4"] > 0 and ld["K6"] > 0,
             "the pg residual did not run inside _spotless_dist")
        need(derr <= DTOL, f"dist model vs pg model {derr} > {DTOL}")
        need(rerr <= TOL, f"rowdist vs pg dirty {rerr} > {TOL}")
        need(lr["K4"] > 0 and lr["K5"] > 0, "rowdist launched no K4/K5")
        need(bderr <= BTOL, f"blocked dist vs all planes {bderr}")
        for k in ("K7", "K8", "K9"):
            need(lbd["blocked"][k] > 0, f"{k} never launched in the blocked "
                 "dist residual")

        # checks of phases 9-14 and of every kernel record
        need(l12["spotless"]["K11"] > 0, "K11 never launched inside the "
             "3072^2 _spotless")
        for k in ("K1", "K2"):
            need(l12["spotless"][k] == 0, f"{k} launched inside the 3072^2 "
                 "_spotless: it did not take the general PSF kernel")
        for k in ("K3c", "K3r"):
            for stage in ("grid", "spotless"):
                need(l12[stage][k] > 0, f"{k} never launched inside the "
                     f"3072^2 _{stage}")
        need(st12["pd_solver"] == "primal_dual_hostloop",
             f"3072^2 spotless ran {st12['pd_solver']}")
        need(l14["K2"] > 0, "K2 never launched in the CG-fused PCG")
        for tag, info in k2_info.items():
            need(info["columns"].startswith("cluster"), f"K2 {tag} took "
                 "the line kernels where K1's cluster route holds")
            need(info["conv_bitwise_k1_of_p"], f"K2 {tag}: conv is not "
                 "K1's of its own p bit for bit")
            need(info["reruns_bitwise"], f"K2 {tag}: reruns differ")
        # every K1 and K2 of the PCG phase ran its column stages on the
        # cluster kernels, which count K2's launches too
        for k in ("K10ac", "K10cc"):
            need(l14[k] == l14["K1"] + l14["K2"], f"the PCG phase: {k} "
                 f"{l14[k]}, K1 {l14['K1']} + K2 {l14['K2']}")
        need(cerr <= CTOL, f"CG-fused vs pcg_bands {cerr} > {CTOL}")
        for k in ("K3c", "K3r", "K7", "K8", "K9"):
            need(lk[k] > 0, f"{k} never launched inside _klean")
        for k in ("K4", "K5", "K6"):
            need(lk[k] == 0, f"{k} launched inside _klean: its residual "
                 "did not take the blocked engine")
        bad = [r["name"] for r in recs if not r["ok"]]
        need(not bad, f"kernel disagrees with its plain version: {bad}")
        need(berr <= BTOL, f"blocked vs all planes at {NX}^2: {berr}")
        for key in ("adjoint_rel_diff", "hessian_rel_diff"):
            need(fl[key] <= BTOL, f"flagship {key} {fl[key]} > {BTOL}")

        def worst(prefix):
            return max(r["max_abs_err"] for r in recs
                       if r["name"].startswith(prefix))

        def first(prefix, key):
            return next(r[key] for r in recs
                        if r["name"].startswith(prefix) and key in r)

        table = [("K1", "psf_convolve_h", "psf_conv.cu",
                  "pfb_tpu/ops/pallas_fft.py:877"),
                 ("K2", "psf_convolve_h_cg", "psf_conv.cu",
                  "pfb_tpu/ops/pallas_fft.py:963"),
                 ("K3", "fftx_c2c", "cfft.cu",
                  "pfb_tpu/ops/pallas_cfft.py:132"),
                 ("K3c", "fftx_c2c_cluster", "cfft_cols.cu",
                  "pfb_tpu/ops/pallas_cfft.py:132"),
                 ("K3r", "fftx_c2c_rows", "cfft_rows.cu",
                  "pfb_tpu/ops/pallas_cfft.py:132"),
                 ("K3f", "fftx_c2c_four", "cfft_four.cu",
                  "pfb_tpu/ops/pallas_cfft.py:132"),
                 ("K3xl", "fftx_c2c_cols_long", "cfft_cols_long.cu",
                  "pfb_tpu/ops/pallas_cfft.py:132"),
                 ("K3yl", "fftx_c2c_rows_long", "cfft_rows_long.cu",
                  "pfb_tpu/ops/pallas_cfft.py:132"),
                 ("K3cl", "fftx_c2c_cluster_long", "cfft_cols.cu",
                  "pfb_tpu/ops/pallas_cfft.py:132"),
                 ("K3fr", "fftx_c2c_four_rows", "cfft_four_rows.cu",
                  "pfb_tpu/ops/pallas_cfft.py:132"),
                 ("K4", "pg_spread", "pg_grid.cu",
                  "pfb_tpu/ops/pgridder.py:330"),
                 ("K5", "pg_fold", "pg_fold.cu",
                  "pfb_tpu/ops/pgridder.py:511"),
                 ("K6", "pg_degrid", "pg_degrid.cu",
                  "pfb_tpu/ops/pgridder.py:848"),
                 ("K7", "pg_spread_gs", "pg_grid.cu",
                  "pfb_tpu/ops/pg_stream.py:379"),
                 ("K8", "pg_fold_gs", "pg_fold.cu",
                  "pfb_tpu/ops/pg_stream.py:481"),
                 ("K9", "pg_degrid_gs", "pg_degrid.cu",
                  "pfb_tpu/ops/pg_stream.py:586"),
                 ("K10a", "psf_stage_cols_fwd", "psf_conv.cu",
                  "pfb_tpu/ops/pallas_fft.py:1075"),
                 ("K10b", "psf_stage_rows", "psf_conv.cu",
                  "pfb_tpu/ops/pallas_fft.py:1110"),
                 ("K10c", "psf_stage_cols_inv", "psf_conv.cu",
                  "pfb_tpu/ops/pallas_fft.py:1153"),
                 ("K10ac", "psf_cols_fwd", "psf_cols.cu",
                  "pfb_tpu/ops/pallas_fft.py:1075"),
                 ("K10cc", "psf_cols_inv", "psf_cols.cu",
                  "pfb_tpu/ops/pallas_fft.py:1153"),
                 ("K10br", "psf_rows", "psf_rows.cu",
                  "pfb_tpu/ops/pallas_fft.py:680"),
                 ("K11", "psf_convolve_full", "psf_conv.cu",
                  "pfb_tpu/ops/pallas_fft.py:1325"),
                 ("K12", "psf_convolve_pallas_v3", "psf_conv.cu",
                  "pfb_tpu/ops/pallas_fft.py:799"),
                 ("K13", "psf_convolve_pallas_v2", "psf_conv.cu",
                  "pfb_tpu/ops/pallas_fft.py:1185"),
                 ("K14", "psf_convolve_pallas_opt", "psf_conv.cu",
                  "pfb_tpu/ops/pallas_fft.py:1255"),
                 ("K15a", "v3_cols_fwd", "psf_conv.cu",
                  "pfb_tpu/ops/pallas_fft.py:745"),
                 ("K15b", "v3_cols_inv", "psf_conv.cu",
                  "pfb_tpu/ops/pallas_fft.py:759"),
                 ("L1", "psf_stage_rows (NXH rows)", "psf_rows.cu",
                  "scripts/wl_kernel_lab.py:108"),
                 ("L2a", "lab_copy", "lab_copy.cu",
                  "scripts/wl_g2i_lab.py:300"),
                 ("L2b", "fftx_c2c_split", "cfft_split.cu",
                  "scripts/wl_g2i_lab.py:170"),
                 ("L2c", "fftx_c2c_lab", "cfft.cu",
                  "scripts/wl_g2i_lab.py:170"),
                 ("L3", "pg_spread (pack_entries)", "pg_grid.cu",
                  "scripts/wl_capacity_ab.py:121"),
                 ("S1", "psi_dot", "sara.cu",
                  "none (the JAX package runs SARA as jnp)"),
                 ("S2", "psi_hdot", "sara.cu",
                  "none (the JAX package runs SARA as jnp)")]
        kern = {"kernels": [
            {"name": name, "route": "cuda",
             "source": f"pfb_tpu_torch/csrc/{src}", "replaces": rep,
             "launches": launches[k], "max_abs_err": worst(k + " "),
             **{key: first(k + " ", key) for key in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}
            for k, name, src, rep in table]}
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print(smi_line)
    print(json.dumps(kern))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
