"""Smoke run of the PyTorch + CUDA port (sycl_points_tpu_torch) on one card.

    python3 chip_smoke.py

1. Builds the CUDA kNN kernels from ``sycl_points_tpu_torch/csrc``.
2. Holds the production kernels (``csrc/knn_cluster.cu``) to exact
   references on the card, bit for bit in indices and distances, at the main
   path's shapes, with every target masked, and on the first 24,575 targets:
   nn1 (1000 queries against the target's voxels under a non-identity pose)
   against nn1_plain; knn_k (k=10 self-search over the voxels with some
   masked) against knn_k_simple, its first design, and against knn_k_plain
   in its sets. Runs the slice on a small pair on the card and through the
   plain versions on the CPU and compares the poses; runs register_pair's
   stages after the voxel step through the production kernels and through
   knn_k_simple + nn1_plain, and requires equal poses, bit for bit.
3. Holds every instance of the study kernels (nn1_tiled, the tile study's
   kernel for the card, at every query tile x chunk; its first design
   nn1_tiled_simple; nn1_bias, nn1_lanes <8> and <32> and nn1_unroll2 in
   nn1_tiled's ring and their first designs nn1_bias_simple,
   nn1_lanes_simple and nn1_unroll2_simple) against nn1_plain at the nn1
   shape, on queries moved by the ground-truth pose,
   with some targets masked, with every target masked, on an odd count of
   targets, on a target of equal adjacent rows whose twins lie in other
   splits, and with masked rows on the queries: equal indices and equal
   distances, bit for bit; times each instance (the ring's kernels through
   their packed targets, made once).
4. Times every kernel, its plain version and a PyTorch yardstick that the
   port never calls (``torch.cdist`` over +inf-masked targets, then ``min``
   or ``topk``), as marginal per-launch CUDA-event times, and computes each
   kernel's bound (``scripts.measure``): the larger of its bytes over
   3.35 TB/s and its FP32 operations (9 a query/target pair) over 33.5e12 a
   second. nn1 and knn_k are timed in turns with their first designs (and
   nn1 with nn1_lanes <32> and <8>, the ring's lane form on a target
   packed once and held to nn1_plain there, and their first designs) at the
   path's shape and at Q=M=22,528; their kernel rows carry these as
   ``previous_ms`` and ``shapes``.
5. Drives the main path, ``apps.example_registration.register_pair``, on a
   synthetic HDL-64 pair (2048 x 64 rays raycast on the card, two poses of a
   figure-8 about 1 m apart) and checks the pose against the ground truth,
   that every output lies on the card, and that nn1 and knn_k launched.
6. Drives the two study entry points (``scripts.bench_nn1_tiles``, both of
   its designs and the cluster nn1, and ``scripts.bench_nn1_variants``) at
   one small shape, each with the launch counts set to 0 just before and
   read just after, and fails if a study kernel never launched or an
   instance differs from nn1_plain there.
7. Drives the LiDAR-odometry frame, ``LidarOdometry.process``, over a
   20-frame replay at the full width of the replay deployment
   (``apps.odometry_replay``: 2048 x 64 rays a scan, 5,000-point scans, a
   2^17-slot voxel-hash map, a 16,384-row target), with the launch counts set
   to 0 just before and read just after. Prints every frame, the ATE, ms per
   frame, launches a frame after the first (the first builds its target from
   the scan) and host syncs a frame, and the stage times of a second
   run whose stages end in a synchronisation. Fails if a frame after the
   first is not ``success``, if fewer than 2 keyframes were taken (the first
   frame is the first), if the ATE
   exceeds MAX_ATE_M, or if nn1 or knn_k never launched.
8. Holds nn1 and knn_k against their exact references, bit for bit, at the
   frame's own shapes, taken from that replay: 1,000 queries under the
   frame's pose against the 16,384-row target (the first frame's, mostly
   masked, and the last keyframe's), the self-search of a 5,000-row scan and
   of the 16,384-row target; times each beside its bound, plain and library
   time.
9. A short replay (512 x 32 rays) from a 2^10-slot map and a 2^9-row target,
   so that map growth, the extract tiers and the re-extraction run on the
   card: fails if the map never grew, if contributions were dropped, or if
   the ATE exceeds MAX_ATE_M. The same replay at the default capacities on
   the card and on the CPU (plain versions): final poses within
   CPU_TRANS_M / CPU_ROT_DEG of each other.
10. Drives the LiDAR-inertial frame, ``LidarInertialOdometry.process``, over
    a 20-frame replay at the full width of the LIO replay deployment
    (``apps.lio_replay``: 2048 x 64 rays, the planar figure-8 at 0.35 m a
    frame, a 400 Hz IMU, 5,000-point scans, a 2^17-slot map, a 16,384-row
    target, Gauss-Newton over the 15-DOF state), with the launch counts set
    to 0 just before and read just after. Prints every frame, ms a frame,
    launches a frame after the first and host syncs a frame, the ATE and the
    final bias errors, and
    the stage times of a second run whose stages end in a synchronisation.
    Fails if a frame after the first is not ``success``, if the ATE exceeds
    MAX_LIO_ATE_M, or if nn1 or knn_k never launched.
11. Holds nn1 and knn_k against their exact references, bit for bit, at the
    LIO frame's own shapes, as in 8.
12. Distorted 512 x 32 sweeps (30 frames at 0.7 m a frame) through the LIO
    frame with the IMU deskew on and off: fails unless the deskew-on ATE is
    at most MAX_DESKEW_ATE_M and at most DESKEW_GAIN times the deskew-off
    ATE. Then ``LidarOdometry`` with the IMU in IMU_SE3 prediction over a
    12-frame 512 x 32 replay: fails above MAX_ATE_M. Then 150 frames of the
    3-D-excited figure-8 at 512 x 32 with constant gyro and accel biases
    injected into the IMU: fails unless the filter recovers at least
    MIN_GYRO_RECOVERED of the gyro bias and ends nearer the accel bias than
    it started. Then a 4-frame 512 x 32 LIO replay on the card and on the
    CPU (plain versions, a 2^12-slot map and a 2^11-row target), every
    sampling stage taking all the points: final
    poses within LIO_CPU_TRANS_M / LIO_CPU_ROT_DEG of each other; and, with
    sampling on, 6 frames on the CPU and on the card with the package's
    seeds and two more seeds: how far apart the final poses are (printed).
13. Drives ``LidarOdometry.process`` at the parameter tree's defaults
    (``apps.odometry_replay.default_params``: polar downsampling, the
    occupancy-grid submap with an insert every frame that passes the inlier
    gate, intensity correction) over the LO phase's 20 full-width scans
    with raw return intensities added, after 3 warm-up frames, with the
    launch counts set to 0 just before and read just after. Prints every
    frame (result, ms, iterations, inliers, whether the map took an insert,
    slots used, occupied voxels, target rows, launches, host syncs), the
    median and maximum ms, launches a frame after the first, the stage split
    of a second run whose stages end in a synchronisation, the final pose
    error, the map's counters, and the submap step and its parts (sampling
    weights, mixed sampling, insert, carve, miss merge, the two resolves,
    extraction, finalize) timed alone. Fails if a frame after the first is
    not ``success``, if the ATE exceeds MAX_ATE_M, if the map took an insert
    on fewer than OG_MIN_INSERTS of the frames after the first, if the last
    target holds fewer than OG_MIN_TARGET valid rows, if the last scan's
    corrected intensities are missing or outside the correction's range, or
    if nn1 or knn_k never launched.
14. Holds nn1 (on the last, warm target under the last pose) and knn_k (on
    the polar-downsampled scan and on the target) against their exact
    references at that path's shapes, as in 8.
15. ``LidarInertialOdometry`` with the default ``scan`` and ``submap`` trees
    over 20 frames at 512 x 32 with intensities: fails above MAX_ATE_M, or
    when a bias error ends above OG_MAX_BIAS_ERR (this replay injects no
    bias). Then the default tree at 512 x 32 with every random stage off,
    on one set of scans with intensities, raycast on the card. The first
    frame's preprocessing on both devices: the points that the refine filter
    (the angle of incidence) keeps on one side only (printed), the corrected
    intensities of the points both keep within OG_INTENSITY_RTOL, and the
    CPU's refined cloud inserted on both devices, maps equal as sets as
    below. Then 6 frames on the card and on the CPU (a 2^12-slot map and a
    2^11-row target): final poses within LIO_CPU_TRANS_M / LIO_CPU_ROT_DEG
    of each other, and the maps equal as sets, log-odds to
    OG_CPU_LOG_ODDS_ATOL, on all but OG_CPU_MAP_SHARE of their voxels.
16. Drives ``PipelinedLidarOdometry.process`` (then ``flush``) over phase
    7's 20 scans at the replay deployment, with the launch counts set to 0
    just before and read just after, the device not drained between
    frames. Prints every frame, ms a frame beside the synchronous frame of
    phase 7, host reads a frame by the ``file:line`` that made them (the
    synchronous frame's too), blocking fetches, the frames left in flight
    when a call returned, launches a frame. Fails unless every deferred
    result is ``success`` with 19 resolved poses, the ATE is within
    MAX_ATE_M, every pose is within PIPE_TRANS_M / PIPE_ROT (rotation
    entries) of phase 7's, nothing was dropped, and nn1 and knn_k launched.
    Then nn1 and knn_k bit-equal at this path's shapes, as in 8.
17. The same over phase 13's scans at the tree's defaults; also fails
    unless the occupied voxels are within max(3, PIPE_VOXEL_SHARE) of phase
    13's and phase 13's bounds on inserts and target rows hold. Prints what
    PIPE_MAX_IN_FLIGHT stashed map states of the default tree's 2^17-slot
    grid take on the card.
18. A pipelined replay (512 x 32, DROP_VOXEL voxels) from a map of
    DROP_CAPACITIES slots: fails unless the drop-retry reconcile fires, its
    map equals as a set (counts exactly, summed positions to DROP_POS_ATOL)
    the map of the sequential ``retry_insert_after_drop`` on the same
    stashed clouds from the same rolled-back state, and the replay ends
    with every result ``success`` and nothing dropped.
19. ``PipelinedLidarInertialOdometry`` over phase 10's inputs, as in 16:
    every deferred result ``success``, ATE within MAX_LIO_ATE_M,
    translations within PIPE_TRANS_M of phase 10's, equal keyframe counts.
20. Checkpoint: ``LidarOdometry`` at the tree's defaults with every
    sampling stage taking all the points, CKPT_FRAMES[0] of phase 13's
    scans, ``save_checkpoint``, CKPT_FRAMES[1] more; the checkpoint loaded
    into a fresh ``LidarOdometry`` and a fresh ``PipelinedLidarOdometry``,
    which run the same frames: fails unless their poses are within
    CKPT_MAX_M of the uninterrupted run's.
21. ``OdometryStreamServer`` (``lo_pipelined``, the replay deployment, the
    default queue depths) on localhost, fed phase 7's 20 scans by
    ``OdometryStreamClient`` at SERVER_HZ: fails unless the 19 poses after
    the bootstrap come back, no scan is dropped, the ATE is within
    MAX_ATE_M. Prints the pose rate and latency (scan sent to pose
    received). Then the same scans closed loop (each sent after the pose of
    the one before): fails unless every pose comes back and the server
    reaches SERVER_HZ frames a second or more; prints the rate reached and
    the latency.
22. ``kitti_odometry.main --pipelined`` on KITTI_FRAMES of phase 13's scans
    written as KITTI ``.bin`` files: fails unless the TUM file has a line a
    frame and the ATE (in the first frame's frame) is within MAX_ATE_M.
23. The fleet at the JAX fleet benchmark's deployment (``apps.fleet_replay``:
    8 streams of 1024 x 32 rays, 40 frames, the figure-8 at 0.35 m a frame
    from turned and shifted starts, the voxel-hash map at 2^16 slots):
    ``FleetOdometry.process_batch`` with the launch counts and host reads
    set to 0 just before and read just after; then, in the same call, the
    single-stream ``PipelinedLidarOdometry`` on stream 0's scans. Prints ms a fleet frame
    (median, max) and a stream frame, stream-frames a second, host reads a
    fleet frame by ``file:line``, batched launches a fleet frame, each
    stream's ATE, the result histogram with every frame that is not a
    success, frames with no result, the final capacity, drops and growth.
    Fails on a frame with no result, more than FLEET_MAX_NOT_OK of the
    stream-frames not a success, a drop, a mean ATE above
    FLEET_MAX_MEAN_ATE_M or a stream's above FLEET_MAX_ATE_M, stream 0 more
    than FLEET_STREAM0_M / FLEET_STREAM0_DEG from the single-stream run at
    any frame, or a batched kernel that never launched.
24. The fleet's kernels at its shapes, from that run: the batched ``nn1``
    (8 x 1,000 queries against the 8 fleet targets of 16,384 rows and their
    own valid counts, under each stream's pose) and the batched ``knn_k``
    (8 x 5,000 scan rows and 8 x 16,384 target rows searched in
    themselves), each bit-equal to 8 single-stream launches and to its plain
    version, also with stream 1's target all masked, on an odd row count
    and with exact ties (each stream's first half twice over);
    each timed (marginal CUDA-event ms, in turns) beside the 8 single
    launches, its plain version, the library call (``torch.cdist`` over the
    stacked streams, then ``min`` / ``topk``) and its bound (the streams'
    valid rows). Where one batched cdist would not fit its launch grid (8 x
    16,384^2 pairs) the library time is one cdist + topk a stream.
25. ``apps.fleet_odometry.run_fleet`` at the tree's defaults
    (``default_kitti_params()``: the occupancy grid at 2^17 slots) over 8
    sequences of FLEET_KITTI_FRAMES KITTI ``.bin`` scans (1024 x 32 rays)
    written from the synthetic world, one sequence FLEET_KITTI_SHORT scans
    long, so the padding path runs: fails unless every TUM file has a pose
    a real scan and every stream's ATE (in its first frame's frame) is
    within FLEET_KITTI_MAX_ATE_M, or if a batched kernel never launched.
    Prints the timing lines of 23.
26. ``FleetLIO`` at the JAX fleet benchmark's ``--lio`` deployment
    (``apps.fleet_replay.run_fleet_lio_replay`` on phase 23's scans: 8
    streams, 40 frames, the IMU at 200 Hz, each stream's known initial
    velocity set after frame 0), with the launch counts and host reads set
    to 0 just before and read just after; then, in the same call, stream 0
    alone through ``PipelinedLidarInertialOdometry``
    (``run_stream_lio_replay``, its generators seeded as stream 0's). Prints
    the timing lines of 23, align iterations a stream-frame and a loop, the
    bias and velocity mirrors, each stream's ATE and the results. Fails on a
    frame with no result, more than FLEET_MAX_NOT_OK not a success, a drop,
    a mean ATE above FLEET_LIO_MAX_MEAN_ATE_M or a stream's above
    FLEET_LIO_MAX_ATE_M, non-finite mirrors, stream 0 more than
    FLEET_STREAM0_M / FLEET_STREAM0_DEG from the single-stream run, or a
    batched kernel that never launched.
27. The batched ``nn1`` and ``knn_k`` at phase 26's shapes, as in 24.
28. ``FleetOdometry`` and ``FleetLIO`` at the tree's default ``scan`` and
    ``submap`` (polar grid, occupancy grid, intensity correction; the LIO
    with the benchmark's IMU noise), FLEET_DEFAULT_STREAMS streams of
    512 x 32 rays with raw return intensities, FLEET_DEFAULT_FRAMES frames,
    each with the counts set to 0 just before and read just after, and
    stream 0 alone through the single-stream pipeline. Prints the timing
    lines of 23, inserts and voxels a stream, the last frame's corrected
    intensities. Fails as 26 does (with FLEET_DEFAULT_MAX_ATE_M for every
    stream and FLEET_STREAM0_M for stream 0), or when the corrected
    intensities are missing or outside the correction's range.
29. The batched ``nn1`` and ``knn_k`` at the shapes of both runs of 28.
30. ``LidarOdometry.process`` at the full-cloud coarse-to-fine deployment
    (``apps.odometry_replay.fullcloud_c2f_params``: 1 m voxels, up to
    30,000 points a scan, registration sampling off, the first 20
    iterations of each align on every 4th target row) over C2F_FRAMES
    full-width scans after C2F_WARMUP warm-up frames, with the counts set to
    0 just before and read just after. Prints every frame, ms a frame
    (median, max), host reads a frame, points registered, nn1 launches a
    frame on the coarse target and on the full one, knn_k launches,
    iterations a frame, the ATE and the final map's voxels beside the JAX
    record's ATE and voxels (for accuracy only). Fails if a frame after the
    first is not a success, if the coarse target is never searched, if a
    frame launched nn1 fewer times than it ran align iterations, if an
    align ends on the coarse target, if the ATE exceeds MAX_C2F_ATE_M, or
    if nn1 or knn_k never launched. Then the same scans with JAX's
    ``max_iterations`` (20, every iteration coarse, as the JAX record ran):
    its ATE beside the record's; and without the coarse phase
    (``coarse_to_fine_iters=0``, 20 iterations): ms, iterations, reads and
    ATE beside the coarse-to-fine run's.
31. nn1 and knn_k at phase 30's shapes, as in 8: every query row of the
    last scan against the coarse target (every 4th row of the 16,384-row
    target) and the full one; the coarse copy of the target's first 10,001
    rows (a partial tail tile) bit-equal too.
32. The first C2F_CPU_FRAMES frames of phase 30's deployment at 512 x 32 on
    the card and on the CPU, every sampler taking every point, on the
    card-vs-CPU map sizes: no align ends on the coarse target, final poses
    within LIO_CPU_TRANS_M / LIO_CPU_ROT_DEG.
33. The LO replay deployment with the rotation constraint (weight
    OPTIONS_ROT_WEIGHT) and nl_reg (the dataclass's thresholds) over phase
    7's scans: fails as phase 7 does; prints ms, iterations, syncs and ATE
    beside phase 7's.
34. The LIO replay deployment with the same two options over phase 10's
    inputs: fails as phase 10 does.
35. ``FleetLIO`` at the ``--lio`` deployment with the same two options over
    the first OPTIONS_FLEET_FRAMES frames of phase 23's scans: fails as
    phase 26 does, stream 0 held to the single-stream run within
    FLEET_STREAM0_M / FLEET_STREAM0_DEG.
36. ``LidarOdometry`` at the tree's defaults with intensity-weighted
    registration sampling over phase 13's scans: fails as phase 13's
    frames and ATE bound do, or if the last frame's draw (made again as the
    frame made it, from the default seed) took fewer than
    ``round(num * weighted_ratio)`` weighted points, or one of zero
    intensity.
37. The raw-features LO frame (``covariance_estimation.raw_range_image``:
    the covariances from the range-image neighbourhoods of the raw scan,
    carried through the downsampling) at the replay deployment over phase
    7's 20 full-width scans and at the tree's defaults over phase 13's,
    each beside the standard frame on the same scans in the same call
    (standard, raw, each again with synchronised stages), the raw run with
    the counts set to 0 just before and read just after. Prints the range
    image's collisions a scan, ms a frame (median, max), the preprocess
    stage, nn1 / knn_k / range_image launches a frame and the ATE of each,
    beside the JAX package's ATE on these scans (JAX_RAW_ATE_M, for
    accuracy only). Then both frames under each of RAW_SEEDS, with the
    deployed (robust) estimator and with the plain one the JAX raw-features
    test runs. Fails if a frame after the first is not a success, if
    range_image or nn1 never launched, or if a raw median ATE falls outside
    RAW_BOUNDS (at the replay deployment with the plain estimator: above
    MAX_ATE_M, or more than RAW_ATE_MARGIN_M from the standard median).
38. The range-image kernels (``csrc/range_image.cu``) against their plain
    versions, bit for bit, on the last full-width scan after the box
    filter, on it with every 3rd return doubled (collisions), with every
    point masked, and on a partial fan with the elevation bounds given: the
    window search (the shared-memory tile, TA columns a block from
    ``range_image_tile``, and the first design, one thread a cell) on the
    image (indices and distances, unfilled slots included) and after the
    self-substitution; the card's ``range_image_knn`` (a memset, the
    elevation, cells, window and rows kernels) against the plain sequence:
    every cell (so every bin), winner and occupancy, every index and
    distance, ``collisions``, and its device launches under the profiler
    (at most 6). Then, in turns: the window kernel, its first design and
    plain version; the card's ``range_image_knn``, the first sequence (the
    plain steps around the first design) and the ``knn_k`` self-search
    (with its target prep) of the standard frame's post-voxel scan, which
    the raw frame no longer runs; the elevation, cells (with its memset)
    and rows kernels beside their plain steps; with each kernel's bound
    (the window: 16 B a cell in, 8 k B a cell out, 9 FP32 operations a
    window pair of occupied cells; the others: their bytes).
39. The raw-features LIO frame at the LIO replay deployment over phase 10's
    inputs beside the standard one, as in 37, with RAW_BOUNDS' LIO entry
    (MAX_LIO_ATE_M for the medians, no margin).
40. The raw LO frame at 512 x 32 on the card and on the CPU, every sampler
    taking every point, on the card-vs-CPU map sizes: final poses within
    CPU_TRANS_M / CPU_ROT_DEG with the deployment's robust estimator (its
    IRLS on raw neighbourhoods amplifies float32 rounding), within
    LIO_CPU_TRANS_M / LIO_CPU_ROT_DEG with the plain one.
41. The rest of the API on the card: the ``PreprocessFilter`` facade's box
    filter and samplers, and statistical and radius outlier removal on a
    full-width scan voxelized at VOXEL with API_OUTLIERS far outliers added
    (every outlier removed, SOR keeping 80% or more, ROR equal to the CPU on
    the card's k-NN, SOR within API_SOR_MAX_FLIPS flips of it);
    farthest-point sampling of API_FPS points (ms, each selected point's
    nearest selected neighbour beside a random draw's, the card's selection
    equal to the CPU's from the same first index); ``scatter_compact``
    against ``compact_device``; the raw frame's processed cloud written as
    PLY (binary, ascii) and PCD (binary, ascii, binary_compressed) and read
    back equal; ``native_io`` built, its readers and prefetching loader
    equal to the Python readers; ``StageTimer`` around raw frames; a
    ``profiling.trace`` of one raw frame whose Chrome trace names the
    cluster nn1 kernel and the four range-image kernels; the covariance markers
    of the raw frame's covariances.
42. The LO replay of phase 7's scans with GridKNN submaps
    (``ops.knn.GRID_KNN_TARGET_THRESHOLD`` set to 0 for the run) and with
    brute-force submaps, in turns (GRID_TURNS, three runs each): every grid
    frame after the first a success that launched ``grid_knn``, ``nn1``
    never, ATE <= MAX_ATE_M and within MAX_GRID_ATE_GAP_M of the brute-force
    runs; ms a frame of each (median, max, keyframes and others), the host
    ms of building the target's search structure on a keyframe, launches,
    build_auto's rebuilds, host syncs.
43. The three structured-search kernels against their plain versions, bit
    for bit, and timed in turns beside ``nn1`` / ``knn_k`` on the same
    inputs, with their bounds (9 FP32 operations a valid candidate; each
    input read once): ``grid_knn`` (``csrc/grid_knn.cu``; a lane group a
    query, at the lanes ``cuda_knn.grid_lanes`` picks and at each of 8, 16
    and 32, and its first design, one thread a query) at the LO frame's
    shapes (1,000 and 5,000 queries against the 16,384-row submap, k = 1
    under the pose and k = 10) and the C2F shapes (C2F_QUERIES against its
    4,096 and 16,384 rows), with a query with no neighbour and one off the
    21-bit range, and on an all-masked target, with ``build_auto``'s host
    ms; the instances above 16 (K = 32, 64, 128) at 5,000 queries; CoarseKNN
    (``csrc/coarse_knn.cu``: ``coarse_rank``, a warp a query over the occupied
    cells, and the lane-group ``coarse_refine``) through ``CoarseKNN.search``
    at C2F_QUERIES against one and eight full-width scans moved into the
    world (COARSE_CELL cells, COARSE_P cells a query), at JAX's default
    capacity (COARSE_L a cell) and at a build sized to the data (the
    capacity from the occupied cells, the budget from the fullest cell, so
    nothing overflows): the search's launches (one of each kernel), the
    certified fraction, every certified row equal to ``nn1``, the ranking bit
    for bit against its plain version (PR 14's matmul + topk ranking beside
    it: the rows whose cells differ), the refine and its first design bit for
    bit against the plain refine (k = 1 and K; an all-masked target), timed
    in turns: the search, the first sequence (the matmul ranking and the first
    refine design) and ``nn1`` on the same target, the ranking and the refine
    each beside its first design, with their bounds; the refine's instances
    above 16; the Morton window (``csrc/window_knn.cu``) through
    ``window_self_knn`` on one full-width scan (K, WINDOW_W, two passes):
    one launch each of ``morton_min``, ``morton_codes``, ``morton_window``
    and ``morton_window_union`` (device launches under the profiler beside
    the first sequence), recall against the exact ``knn_k`` (above 0.70),
    every kernel bit for bit against its plain version at k = K, 32, 64 and
    128 (an all-masked scan and the shadowing scenes too), each kernel timed
    in turns with its plain version (the pass with its first design,
    ``morton_window_simple``), ``window_self_knn`` with the first sequence,
    the plain two passes and ``knn_k``, and its instances above 16.
44. ``preprocess_pair`` on the pair's raw scans against two sequential
    preprocesses (voxels, covariances, normals bit for bit; ms of each in
    turns); ``sharded_align`` on ``make_mesh()`` (the one card) equal to
    ``align`` in every field, and on a two-entry mesh of the card (two
    shards, their partials added) within SHARDED_T_TOL of ``align`` on T
    with equal inliers; ``device_info()``.
45. k above 16 (``cuda_knn.FAST_MAX_K``): phase 7's full-width LO replay at
    ``neighbor_num`` LARGE_NEIGHBORS, with the standard covariances (knn_k
    at k = 20: its K = 32 instance) and with the raw range-image ones (the
    plain estimator), each under LARGE_SEEDS with the counts at 0: ms a
    frame, launches a frame, the median ATE within LARGE_MAX_ATE_M (about
    1.3x the JAX package's on these scans: at neighbor_num 20 this
    deployment tracks at ~0.15-0.18 m in JAX too, so MAX_ATE_M does not
    hold); then at each k of LARGE_KS knn_k on the
    frame's scan, knn_k_batched on LARGE_BATCH streams of it and the
    range-image window on the raw full-width scan, bit for bit against the
    tie-ordered plain versions (``knn_k_sorted_plain``, one launch a stream)
    and the one-thread instances (``knn_k_spill``), the first 16 columns against
    the k = 16 search, timed in turns with k = K, with ``knn_k_spill`` and
    with cdist + topk at the same k, beside their bounds; the range-image
    window (a warp a cell above 16) at k = 20, 32, 64 and 117 (the default
    window's 117 candidates: its K = 128 instance), bit for bit against its
    plain version and its one-thread instances (``range_image_window_spill``),
    timed in turns with them and k = 10. ``-Xptxas -v`` of ``range_image.cu``
    beside the others: no warp instance may spill. The kernels' JSON line
    gains a row for each instance above 16, for ``knn_k_spill`` and for
    ``range_image_spill``.

46. The fleet split over a mesh (``FleetOdometry(mesh=...)``, a shard of B /
    n streams a device, on a host thread and a CUDA stream of its own) at
    phase 23's deployment: first whether a blocking read (``sync.to_host``,
    ``DeferredFetch.get``) lets another Python thread run (its spins a
    second beside the same thread's alone; fails under SHARDED_GIL_MIN; the
    shards take turns on the host and give the turn up while they wait);
    then the one-entry mesh ``[cuda:0]`` bit-equal to the unsharded fleet in
    every pose; then the two-shard mesh ``[cuda:0, cuda:0]`` in turns with
    the unsharded fleet (SHARDED_TURNS), the counts at 0 before each sharded
    run: ms a fleet frame (median, max), stream-frames a second, reads a
    fleet frame by source for each shard, batched launches a fleet frame (a
    shard's and the total); each stream's poses, frame by frame, within
    SHARDED_M / SHARDED_DEG of the unsharded fleet's, the fleet's ATE
    bounds, the same growth events. ``FleetLIO`` on the same mesh at the
    ``--lio`` deployment (SHARDED_LIO_FRAMES frames) against the unsharded
    ``FleetLIO``, in turns, within the same bounds. The batched ``nn1`` and
    ``knn_k`` at a shard's shapes (B / 2 streams), as in 24, their launches
    those of the sharded LO runs.

Prints per-phase results, then a JSON line of kernel results, the card's name
and power limit, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check raises (exit code != 0). Without a CUDA card it exits with
an error before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter

import numpy as np
import torch

from sycl_points_tpu_torch.apps import (
    fleet_odometry,
    fleet_replay,
    kitti_odometry,
    lio_replay,
    odometry_replay,
    stream_protocol,
)
from sycl_points_tpu_torch.apps import covariance_markers
from sycl_points_tpu_torch.apps.example_registration import (
    PAIR_PARAMS,
    downsample,
    pose_error,
    preprocess,
    register_pair,
    voxel_capacity,
)
from sycl_points_tpu_torch.apps.odometry_replay import FRAME_KERNELS
from sycl_points_tpu_torch.convert import cloud_from_numpy
from sycl_points_tpu_torch.mapping import occupancy_grid as og
from sycl_points_tpu_torch.mapping import voxel_hash_map as vhm
from sycl_points_tpu_torch.mapping.hash_table import resolve_slots, resolve_slots_tiered
from sycl_points_tpu_torch.ops import coarse_knn, cuda_knn, grid_knn, range_image_knn, sampling, window_knn
from sycl_points_tpu_torch.ops import knn as knn_module
from sycl_points_tpu_torch.ops.coarse_knn import CoarseKNN
from sycl_points_tpu_torch.ops.grid_knn import GridKNN
from sycl_points_tpu_torch.ops.pair_preprocess import preprocess_pair
from sycl_points_tpu_torch.parallel import sharded
from sycl_points_tpu_torch.ops.covariance import estimate_covariances, extract_normals
from sycl_points_tpu_torch.ops.filters import box_filter, radius_outlier_removal, statistical_outlier_removal
from sycl_points_tpu_torch.ops.knn import BruteForceKNN, KNNResult, self_knn
from sycl_points_tpu_torch.ops.prefix_sum import compaction_offsets, scatter_compact
from sycl_points_tpu_torch.ops.preprocess_filter import PreprocessFilter
from sycl_points_tpu_torch.ops.sampling import mixed_sampling, random_sampling, random_sampling_streams
from sycl_points_tpu_torch.ops.transform import transform_points
from sycl_points_tpu_torch.ops.voxel import voxel_coords, voxel_downsample
from sycl_points_tpu_torch.apps.stream_odometry import OdometryStreamClient, OdometryStreamServer, StreamServerConfig
from sycl_points_tpu_torch.pipeline.checkpoint import load_checkpoint, save_checkpoint
from sycl_points_tpu_torch.pipeline.lidar_odometry import LidarOdometry
from sycl_points_tpu_torch.parallel.fleet import ShardedFleetLIO, ShardedFleetOdometry, stream_seeds
from sycl_points_tpu_torch.scripts import window_scenes
from sycl_points_tpu_torch.pipeline.params import CovarianceEstimationParams, MotionPredictionParams, PoseParams
from sycl_points_tpu_torch.pipeline.pc_processor import PCProcessor
from sycl_points_tpu_torch.pipeline.pipelined_odometry import PipelinedLidarOdometry
from sycl_points_tpu_torch.pipeline.submap import Submap
from sycl_points_tpu_torch.registration.degenerate import DegenerateRegularizationParams
from sycl_points_tpu_torch.registration.pipeline import align_pipeline
from sycl_points_tpu_torch.registration.registration import (
    RegistrationParams,
    RotationConstraintParams,
    align,
    compute_icp_robust_weights,
)
from sycl_points_tpu_torch.utils.device import device_info
from sycl_points_tpu_torch.scripts import bench_nn1_tiles, bench_nn1_variants
from sycl_points_tpu_torch.scripts.measure import FP32_OPS_PER_S, OPS_PER_PAIR, bound, marginal_ms, nn1_bound
from sycl_points_tpu_torch.utils import lie, lie_np, profiling, sync
from sycl_points_tpu_torch.utils.timing import StageTimer
from sycl_points_tpu_torch.points import io, native_io
from sycl_points_tpu_torch.points.conversion import read_kitti_bin
from sycl_points_tpu_torch.points.point_cloud import PointCloud, compact_device, merge, pad_capacity_for
from sycl_points_tpu_torch.utils.synthetic import World, figure8_trajectory, fleet_trajectories, scan_at

VOXEL = 0.25
K = 10
N_QUERIES = 1000
SEED = 1234
TIE_TOL = 1e-6  # index disagreements allowed only between distances this close
D2_ATOL = 1e-5  # squared-distance agreement, kernel vs plain
MAX_TRANS_ERR_M = 0.05
MAX_ROT_ERR_DEG = 0.5
KNN_SOURCE = "sycl_points_tpu_torch/csrc/knn_cluster.cu"
FIRST_SOURCE = "sycl_points_tpu_torch/csrc/knn.cu"
TILES_SOURCE = "sycl_points_tpu_torch/csrc/nn1_tiles.cu"
VARIANTS_SOURCE = "sycl_points_tpu_torch/csrc/nn1_variants.cu"
STUDY_SHAPE = ((1024, 6144),)  # the TPU variant study's small shape
MASK_EVERY = 37
# The LiDAR-odometry replays. The ATE limit is about twice what the card
# showed on the full-width replay (0.051 m over 20 frames, H100).
LO_FRAMES = 20
LO_WARMUP = 3
MAX_ATE_M = 0.10
SMALL_RAYS = (512, 32)
GROWTH_FRAMES = 12
GROWTH_CAPACITIES = (1 << 10, 1 << 9)
CPU_FRAMES = 6
CPU_TRANS_M, CPU_ROT_DEG = 0.02, 0.1
LO_PATH = "LidarOdometry.process"
# The LiDAR-inertial replays. The full-width bound is about 1.3 x the JAX
# package's own 0.231 m over 60 frames of the same replay; the deskew bound
# and the deskew-on-below-off test are those of the JAX package's LIO deskew
# test, with a margin: on must stay within DESKEW_GAIN of off (the card
# showed 0.13 against 0.25 m, H100).
LIO_PATH = "LidarInertialOdometry.process"
LIO_FRAMES = 20
LIO_WARMUP = 3
MAX_LIO_ATE_M = 0.30
DESKEW_FRAMES = 30
DESKEW_SPEED = 0.7
MAX_DESKEW_ATE_M = 0.25
DESKEW_GAIN = 0.7
LO_IMU_FRAMES = 12
# Card against CPU with every point taken: about 12 x the 0.168 mm and
# 14 x the 0.00072 deg the card showed (H100). With sampling on, the two
# generators draw different points; that run and two more sampling seeds on
# the card are printed beside it, unbounded, as the spread that sampling
# alone makes.
# The CPU's plain k-NN scans every row of the target, so these replays hold
# a 2^12-slot map and a 2^11-row target, which keep every voxel they see.
LIO_CPU_FRAMES = 4
LIO_CPU_TRANS_M, LIO_CPU_ROT_DEG = 2e-3, 0.01
LIO_CPU_CAPACITIES = (1 << 12, 1 << 11)
SAMPLED_FRAMES = 6
SAMPLING_SEEDS = (7, 11)
# Bias recovery on the 3-D-excited figure-8 at 512 x 32, the JAX package's
# CPU-scale setting (benchmarks/REPLAY_LIO_BIAS3D_r5.json: these biases and
# bias random walks, 150 frames; it recovered 85% of the gyro bias and 73% of
# the accel bias). The phase fails unless the gyro bias is at least half
# recovered and the accel bias error ends below the injected bias.
BIAS_FRAMES = 150
GYRO_BIAS = (0.02, -0.01, 0.015)  # rad/s
ACCEL_BIAS = (0.05, 0.03, -0.04)  # m/s^2
BIAS_RW = (1e-4, 1e-3)  # gyro, accel bias random-walk densities
MIN_GYRO_RECOVERED = 0.5
MAX_BIAS_ATE_M = 0.5
# The parameter tree's defaults. The JAX package on the CPU, on the LO
# phase's 20 frames: every frame a success, ATE 0.0356 m, an insert on 19 of
# the 19 frames after the first, a last target of 1,182 rows; its LIO with
# the default trees at 512 x 32: ATE 0.017 m, bias errors 3e-4 rad/s and
# 4e-3 m/s^2.
OG_PATH = "LidarOdometry.process (default tree)"
OG_MIN_INSERTS = 15
OG_MIN_TARGET = 600
OG_LIO_FRAMES = 20
OG_MAX_BIAS_ERR = (0.01, 0.1)  # gyro rad/s, accel m/s^2
OG_CPU_FRAMES = 6
# A point on a voxel edge may move with the last bits of the pose, and with
# it a hit and the end of its ray's carve.
OG_CPU_MAP_SHARE = 0.01
OG_INTENSITY_RTOL = 1e-5  # the corrected intensities, card vs CPU (the CPU tests' bound)
OG_CPU_LOG_ODDS_ATOL = 1e-5
# The serving path. The pipelined frames are held to the synchronous run of
# the same call with the JAX package's bounds (tests/test_pipelined_odometry.py:
# translation 0.02 m, rotation entries 0.01; tests/test_pipelined_lio.py:
# translation 0.02 m) and their occupied-voxel count to max(3, 2%).
PIPE_TRANS_M, PIPE_ROT = 0.02, 0.01
PIPE_VOXEL_SHARE = 0.02
PIPE_MAX_IN_FLIGHT = 16
LO_PIPE_PATH = "PipelinedLidarOdometry.process"
OG_PIPE_PATH = "PipelinedLidarOdometry.process (default tree)"
LIO_PIPE_PATH = "PipelinedLidarInertialOdometry.process"
# The drop retry: the JAX test's 128 slots; 0.5 m voxels, so that a keyframe
# brings more new voxels than the table can probe for.
DROP_FRAMES = 12
DROP_CAPACITIES = (128, 64)
DROP_VOXEL = 0.5
DROP_POS_ATOL = 1e-3  # summed positions of a voxel, chain vs sequential (sums of up to ~100 points)
CKPT_FRAMES = (10, 10)
CKPT_MAX_M = 1e-5
SERVER_HZ = 10.0  # the sensor's scan rate
KITTI_FRAMES = 10
# The fleet at the JAX fleet benchmark's deployment. The JAX package's record
# of it is a mean ATE of 0.211 m and a worst stream of 0.431 m, one
# stream-frame of 312 not a success (benchmarks/FLEET_r4.json); the bounds
# give it room. Stream 0 and the single-stream replay of its scans share
# their generators' seeds (parallel.fleet.stream_seeds).
FLEET_PATH = "FleetOdometry.process_batch"
FLEET_RUNNER_PATH = "fleet_odometry.run_fleet (default tree)"
FLEET_MAX_MEAN_ATE_M = 0.30
FLEET_MAX_ATE_M = 0.60
FLEET_MAX_NOT_OK = 0.01
FLEET_STREAM0_M, FLEET_STREAM0_DEG = 1e-3, 0.01
FLEET_KITTI_FRAMES = 20
FLEET_KITTI_SHORT = 14
FLEET_KITTI_MAX_ATE_M = 0.30
FLEET_CDIST_MAX_PAIRS = 1 << 30  # the batched cdist yardstick launches up to here
# The ragged fleet case's extents, spread over the streams (the last one the
# capacity): none valid, one row, either side of a 32-row unit and of the
# 512-row tile, a submap extraction's ~430.
RAGGED_EXTENTS = (0, 1, 31, 33, 430, 511, 513)
# The LIO fleet at the benchmark's --lio deployment: the JAX package's record
# of it is a mean ATE of 0.145 m and a worst stream of 0.219 m, one
# stream-frame of 312 not a success (benchmarks/FLEET_LIO_r4.json).
FLEET_LIO_PATH = "FleetLIO.process_batch"
FLEET_LIO_MAX_MEAN_ATE_M = 0.30
FLEET_LIO_MAX_ATE_M = 0.60
# Both fleets at the tree's defaults: B streams at 512 x 32 (the grid inserts
# every frame past the inlier gate). In the 4-stream layout stream 1's
# figure-8 enters one of the world's boxes at frame 13, where its scans
# come back empty, so the run stops before it.
FLEET_DEFAULT_PATH = "FleetOdometry.process_batch (default tree)"
FLEET_LIO_DEFAULT_PATH = "FleetLIO.process_batch (default trees)"
FLEET_DEFAULT_STREAMS = 4
FLEET_DEFAULT_FRAMES = 12
FLEET_DEFAULT_WARMUP = 2
FLEET_DEFAULT_MAX_ATE_M = 0.15
# The registration options. The full-cloud coarse-to-fine deployment
# (apps.odometry_replay.fullcloud_c2f_params) over the JAX record's 30
# frames of 2048 x 64. The JAX record (benchmarks/REPLAY_FULLCLOUD_C2F_r4.json)
# read an ATE of 0.325 m with every iteration on the coarse target; the
# bound gives the port's run, refined on the full target, that value with
# room. The card against the CPU takes every point (no draw) on the
# card-vs-CPU map sizes, with the LIO's card-vs-CPU bounds.
C2F_PATH = "LidarOdometry.process (full-cloud C2F)"
C2F_FRAMES = 30
C2F_WARMUP = 3
C2F_CPU_FRAMES = 3
MAX_C2F_ATE_M = 0.40
JAX_C2F_ATE_M = 0.325
JAX_C2F_VOXELS = 803
# The rotation constraint (at the JAX test's weight) and nl_reg (at the
# dataclass's thresholds) on the LO, LIO and fleet-LIO deployments, held to
# those deployments' bounds; the fleet at a cut depth.
OPTIONS_ROT_WEIGHT = 0.5
OPTIONS_FLEET_FRAMES = 20
# The raw range-image path: the raw-features frames beside the standard ones
# on the same scans, their ATE within the JAX raw-features test's margin of
# the standard one (tests/test_raw_features.py:116); the range-image kernel
# (not a TPU port: JAX computes the search in XLA ops) at the full width.
RAW_PATH = "LidarOdometry.process (raw features)"
RAW_SOURCE = "sycl_points_tpu_torch/csrc/range_image.cu"
RAW_REPLACES = "sycl_points_tpu/ops/range_image_knn.py:113"
# the JAX steps the card path's other range-image kernels replace
RAW_ELEVATION_REPLACES = "sycl_points_tpu/ops/range_image_knn.py:72"
RAW_CELLS_REPLACES = "sycl_points_tpu/ops/range_image_knn.py:89"
RAW_ROWS_REPLACES = "sycl_points_tpu/ops/range_image_knn.py:132"
RAW_ANGLE_OPS = 40  # FP32 operations a point of r, atan2 and asin (bounds of the per-point kernels)
MAX_RANGE_IMAGE_LAUNCHES = 6
RAW_KERNELS = ("range_image_elevation", "range_image_cells", "range_image", "range_image_rows")
# The structured searches (ROADMAP Queue 1 item 12): GridKNN behind the LO
# frame's submap, CoarseKNN at 30,000 queries against one and eight scans,
# the Morton window on one scan.
GRID_PATH = "LidarOdometry.process (GridKNN submap)"
GRID_SOURCE = "sycl_points_tpu_torch/csrc/grid_knn.cu"
GRID_REPLACES = "sycl_points_tpu/ops/grid_knn.py:139"
COARSE_PATH = "CoarseKNN.search"
COARSE_SOURCE = "sycl_points_tpu_torch/csrc/coarse_knn.cu"
COARSE_REPLACES = "sycl_points_tpu/ops/coarse_knn.py:157"
COARSE_RANK_REPLACES = "sycl_points_tpu/ops/coarse_knn.py:137"
WINDOW_PATH = "window_self_knn"
WINDOW_SOURCE = "sycl_points_tpu_torch/csrc/window_knn.cu"
WINDOW_REPLACES = "sycl_points_tpu/ops/window_knn.py:103"
WINDOW_CODES_REPLACES = "sycl_points_tpu/ops/window_knn.py:54"
WINDOW_UNION_REPLACES = "sycl_points_tpu/ops/window_knn.py:146"
MAX_GRID_ATE_GAP_M = 0.02
C2F_QUERIES = 30000
GRID_TURNS = ("brute", "grid", "grid", "brute", "brute", "grid")
COARSE_CELL = 1.0
COARSE_L = 256
COARSE_P = 8
COARSE_PLAIN_QUERIES = 512  # the sized build's plain check: its [q, P, L] block at a budget of thousands
WINDOW_W = 64
# k above 16 (cuda_knn.FAST_MAX_K): the LO frame at neighbor_num 20, and the
# instances at K = 32, 64 and 128 timed in turns with k = K (10)
LARGE_NEIGHBORS = 20
LARGE_KS = (20, 32, 64, 128)
LARGE_PATH = "LidarOdometry.process (neighbor_num 20)"
LARGE_RAW_PATH = "LidarOdometry.process (raw features, neighbor_num 20)"
LARGE_SEEDS = (None, 1, 3)  # the frames' ATE: a median over these sampling seeds (None: the package's)
# At neighbor_num 20 the replay deployment tracks worse in both packages: the
# JAX package reads 0.1569 m (standard, robust estimator), 0.1487 (standard,
# plain) and 0.1812 (raw, plain) on these scans on the CPU at its seeds
# (tests/test_torch_raw_ate.py --neighbor-num 20), against 0.0433 at 10. So
# MAX_ATE_M cannot hold there; each frame is held to about 1.3x JAX's ATE,
# as the LIO frame is (MAX_LIO_ATE_M).
JAX_LARGE_ATE_M = {"standard": 0.1569, "raw": 0.1812}
LARGE_MAX_ATE_M = {"standard": 0.20, "raw": 0.24}
LARGE_BATCH = 8
RANK_OPS = 14  # FP32 operations of a (query, cell) bound: q.c 5, q2 + c2 - 2 q.c 3, two clamps, sqrt, two subs, compare
SHARDED_T_TOL = 1e-4  # tests/test_multichip.py's bound on T for a split source
# The fleet split over a mesh of the one card: the two-shard fleets against
# the unsharded ones (the batched products sum in another order at B / 2
# streams), in turns; a blocking read must let another thread run at
# SHARDED_GIL_MIN of its spins alone at least.
SHARDED_FLEET_PATH = "FleetOdometry.process_batch (mesh [cuda:0, cuda:0], a shard)"
SHARDED_M, SHARDED_DEG = 1e-3, 0.01
SHARDED_TURNS = ("unsharded", "two shards", "two shards", "unsharded")
SHARDED_LIO_FRAMES = 20
SHARDED_LIO_WARMUP = 3
SHARDED_GIL_MIN = 0.25
RAW_ATE_MARGIN_M = 0.02
RAW_CPU_FRAMES = 4
# The deployments run the robust (IRLS) covariance estimator. On the raw
# 2048-column scan a point's nearest neighbours lie mostly along its own
# ring, and with the samplers' draw the raw frames' ATE spreads widely: on
# the card 0.056-0.388 m (LO) and 0.029-0.569 m (LIO) over eight seeds,
# medians 0.133 and 0.130 m, where JAX's own raw frames read 0.134 and
# 0.141 m on these scans on the CPU at its seeds (JAX_RAW_ATE_M, from
# tests/test_torch_raw_ate.py). So a raw frame is held by the median over
# RAW_SEEDS, as deployed and with the plain estimator that the JAX
# raw-features test runs: RAW_BOUNDS gives, for each deployment, the robust
# median's bound, the plain median's and the plain margin to the standard
# median. The issue's 0.10 m and the test's 0.02 m margin hold at the
# replay deployment with the plain estimator; the default tree's polar grid
# trails in JAX too (0.0979 against 0.0354 m), so there no margin.
RAW_SEEDS = (None, 1, 3, 5, 7, 9, 11, 13)  # None: the package's own seeds
RAW_BOUNDS = {"replay deployment": (0.20, MAX_ATE_M, RAW_ATE_MARGIN_M), "default tree": (0.20, 0.20, None),
              "LIO replay deployment": (MAX_LIO_ATE_M, MAX_LIO_ATE_M, None)}
JAX_RAW_ATE_M = {"replay deployment": {"robust": (0.1342, 0.0433), "plain": (0.0546, 0.0448)},
                 "default tree": {"robust": (0.1478, 0.0365), "plain": (0.0979, 0.0354)},
                 "LIO replay deployment": {"robust": (0.1413, 0.0889), "plain": (0.0981, 0.0524)}}
# The rest of the API on the card: far outliers added to a voxelized scan,
# the farthest-point draw, the covariance markers. SOR's global sums run in
# another order on the card than on the CPU, so a point within rounding of
# the threshold may flip.
API_OUTLIERS = 50
API_SOR_MAX_FLIPS = 3
API_FPS = 1024
API_MARKERS = 500


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def in_turns(fns: dict, rounds: int = 2) -> dict:
    """Median marginal per-launch CUDA-event ms of each call, timed in turns:
    every call in order, then in reverse order, ``rounds`` times."""
    dev = torch.device("cuda", torch.cuda.current_device())
    order = list(fns)
    times = {name: [] for name in order}
    for _ in range(rounds):
        for name in order + order[::-1]:
            times[name].append(marginal_ms(fns[name], dev))
    return {name: statistics.median(v) for name, v in times.items()}


def compare_times(kernel_fn, plain_fn, library_fn):
    """(kernel ms, plain ms) in turns plain, kernel, kernel, plain, and one
    time of the library call."""
    t = in_turns({"plain": plain_fn, "kernel": kernel_fn})
    return t["kernel"], t["plain"], marginal_ms(library_fn, torch.device("cuda", torch.cuda.current_device()))


def inf_masked(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Targets with masked rows moved to +inf, the yardstick's input."""
    return torch.where(mask.bool()[:, None], points, torch.inf).contiguous()


def cdist_min(q: torch.Tensor, t_inf: torch.Tensor):
    """The yardstick of nn1: PyTorch's exact pairwise distances, then min."""
    return torch.cdist(q, t_inf, compute_mode="donot_use_mm_for_euclid_dist").min(dim=1)


def row(name, source, replaces, path, err, times, bound_ms_by, **extra) -> dict:
    ms, plain_ms, library_ms = times
    b_ms, b_by = bound_ms_by
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "path": path,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms, **extra}


def finite_max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    fin = torch.isfinite(a) & torch.isfinite(b)
    if not bool((torch.isfinite(a) == torch.isfinite(b)).all()):
        raise AssertionError("kernel and plain disagree on which distances are finite")
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


def exact_cases(points: torch.Tensor, mask: torch.Tensor) -> dict:
    """The bit-equality cases: the path's target, every target masked, and
    the first odd number of targets (off the 512-target tile and the 8
    slices of the cluster kernels, and off every tile of the first designs)."""
    n_odd = (points.shape[0] - 1) | 1
    return {"path": (points, mask), "all masked": (points, torch.zeros_like(mask)),
            f"first {n_odd} targets": (points[:n_odd], mask[:n_odd])}


def check_equal(name: str, got, ref, what: str) -> None:
    bad = int((got[0] != ref[0]).sum())
    if bad or not torch.equal(got[1], ref[1]):
        raise AssertionError(f"{name} ({what}): {bad} index mismatches, distances equal: {torch.equal(got[1], ref[1])}")


def n_sm() -> int:
    return torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count


def second_shape():
    """The studies' Q=M=22,528 inputs (uniform +-50 m, every 37th target
    masked), as targets, uint8 mask and queries on the card."""
    Q = M = 22528
    return bench_nn1_variants.study_inputs(np.random.default_rng(0), Q, M, bench_nn1_variants.MASK_EVERY,
                                           torch.device("cuda", torch.cuda.current_device()))


def check_nn1(target, queries, pose) -> dict:
    """The production nn1 (cluster kernel) equal to nn1_plain bit for bit
    under the path's pose in every exact case. Times, in turns, at the path's
    shape and at Q=M=22,528: ``ms`` the kernel through nn1_prepped (the ICP
    loop's per-iteration call, target prepared once), ``public_ms`` nn1
    (prep_target included), ``previous_ms`` the first design (nn1_tiled_simple
    <128, 2048>), the nn1_lanes <32> and <8> study kernels (the ring's lane
    form through nn1_lanes_prepped on a target packed once, held to
    nn1_plain bit for bit there, and their first designs as
    ``lanes{32,8}_simple_ms``), and nn1_plain. The first design and the
    lanes kernels take no pose, so they get the queries already moved."""
    mask = target.mask.to(torch.uint8)
    t = target.points
    for what, (tt, m) in exact_cases(t, mask).items():
        got = cuda_knn.nn1(tt, m, queries, pose)
        ref = cuda_knn.nn1_plain(tt, m, queries, pose)
        torch.cuda.synchronize()
        check_equal("nn1", got, ref, what)
        if what == "all masked" and not (bool(torch.isinf(got[1]).all()) and bool((got[0] == 0).all())):
            raise AssertionError("nn1 with every target masked must give idx 0, d2 = inf")
    print(f"nn1: Q={queries.shape[0]} M={target.capacity} (valid {int(target.count())}): equal to nn1_plain "
          f"bit for bit ({', '.join(exact_cases(t, mask))})")

    moved = transform_points(queries, pose).contiguous()
    library_ms = marginal_ms(lambda: cdist_min(moved, inf_masked(t, mask)), t.device)
    shapes = {}
    for label, (tt, m, q, p) in {"path": (t, mask, queries, pose), "Q=M=22528": (*second_shape(), None)}.items():
        qm = q if p is None else moved
        pr = cuda_knn.prep_target(tt, m)
        pb = cuda_knn.pack_bias_target(tt, m)
        check_equal("nn1", cuda_knn.nn1_prepped(pr, q, p), cuda_knn.nn1_plain(tt, m, q, p), label)
        for lanes in cuda_knn.NN1_LANES:
            check_equal("nn1_lanes", cuda_knn.nn1_lanes_prepped(pb, qm, lanes), cuda_knn.nn1_plain(tt, m, qm),
                        f"{label}, {lanes} lanes")
        turns = in_turns({
            "ms": lambda: cuda_knn.nn1_prepped(pr, q, p),
            "previous_ms": lambda: cuda_knn.nn1_tiled_simple(tt, m, qm, 128, 2048),
            "lanes32_ms": lambda: cuda_knn.nn1_lanes_prepped(pb, qm, 32),
            "lanes8_ms": lambda: cuda_knn.nn1_lanes_prepped(pb, qm, 8),
            "lanes32_simple_ms": lambda: cuda_knn.nn1_lanes_simple(tt, m, qm, 32),
            "lanes8_simple_ms": lambda: cuda_knn.nn1_lanes_simple(tt, m, qm, 8),
            "public_ms": lambda: cuda_knn.nn1(tt, m, q, p),
            "plain_ms": lambda: cuda_knn.nn1_plain(tt, m, q, p),
        })
        sb = nn1_bound(q.shape[0], tt.shape[0], int(m.sum()))
        qt, slices = cuda_knn.cluster_shape(q.shape[0], cuda_knn.NN1_QUERY_TILES, n_sm())
        shapes[label] = {"Q": q.shape[0], "M": tt.shape[0], "valid": int(m.sum()), **turns,
                         "bound_ms": sb[0], "bound_by": sb[1], "query_tile": qt, "slices": slices}
        print(f"nn1 at {label} (Q={q.shape[0]}, M={tt.shape[0]}, {qt} queries x {slices} slices a cluster), "
              f"marginal CUDA-event ms per launch, medians in turns: "
              + ", ".join(f"{k} {v:.4f}" for k, v in turns.items()) + f"; bound {sb[0]:.4f} ({sb[1]})")
    print(f"nn1 library (cdist + min at the path's shape): {library_ms:.4f} ms")
    path = shapes["path"]
    return row("nn1", KNN_SOURCE, "sycl_points_tpu/ops/pallas_knn.py:111", "register_pair", 0.0,
               (path["ms"], path["plain_ms"], library_ms), (path["bound_ms"], path["bound_by"]),
               previous_ms=path["previous_ms"], shapes=shapes)


def knn_bound(Q: int, M: int, n_valid: int, k: int):
    # the distance and the compare against the k-th best of every pair; the
    # data-dependent insertions are not counted
    return bound(Q * n_valid, 13 * M + 12 * Q + 8 * Q * k)


def check_knn(cloud) -> dict:
    """The production knn_k (cluster kernel) equal to knn_k_simple (the first
    design) bit for bit in every exact case, and to knn_k_plain in its sets.
    Times, in turns, at the path's shape (k=10 self-search) and at
    Q=M=22,528: ``ms`` the kernel through knn_k_prepped, ``public_ms`` knn_k
    (prep_target included, the path's self_knn call), ``previous_ms`` the
    first design, and knn_k_plain."""
    keep = torch.arange(cloud.capacity, device=cloud.device) % 10 != 3
    pts, mask = cloud.points, cloud.mask & keep
    for what, (tt, m) in exact_cases(pts, mask).items():
        got = cuda_knn.knn_k(tt, m, pts, K)
        check_equal("knn_k", got, cuda_knn.knn_k_simple(tt, m, pts, K), what)
    idx, d2 = cuda_knn.knn_k(pts, mask, pts, K)
    ref_idx, ref_d2 = cuda_knn.knn_k_plain(pts, mask, pts, K)
    torch.cuda.synchronize()
    bad = cuda_knn.knn_mismatches(idx, d2, ref_idx, ref_d2, TIE_TOL)
    err = finite_max_abs_err(d2, ref_d2)
    print(f"knn_k: k={K} Q=M={cloud.capacity} (valid {int(mask.sum())}): equal to knn_k_simple bit for bit "
          f"({', '.join(exact_cases(pts, mask))}); {bad} set mismatches against knn_k_plain beyond ties, "
          f"max |d2 - plain| = {err:.3g}")
    if bad or err > D2_ATOL:
        raise AssertionError("knn_k kernel disagrees with its plain version")
    t_inf = inf_masked(pts, mask)
    library_ms = marginal_ms(
        lambda: torch.cdist(pts, t_inf, compute_mode="donot_use_mm_for_euclid_dist").topk(K, largest=False),
        pts.device)
    shapes = {}
    for label, (tt, m, q) in {"path": (pts, mask, pts), "Q=M=22528": second_shape()}.items():
        pr = cuda_knn.prep_target(tt, m)
        check_equal("knn_k", cuda_knn.knn_k_prepped(pr, q, K), cuda_knn.knn_k_simple(tt, m, q, K), label)
        turns = in_turns({
            "ms": lambda: cuda_knn.knn_k_prepped(pr, q, K),
            "previous_ms": lambda: cuda_knn.knn_k_simple(tt, m, q, K),
            "public_ms": lambda: cuda_knn.knn_k(tt, m, q, K),
            "plain_ms": lambda: cuda_knn.knn_k_plain(tt, m, q, K),
        })
        sb = knn_bound(q.shape[0], tt.shape[0], int(m.sum()), K)
        qt, slices = cuda_knn.cluster_shape(q.shape[0], (cuda_knn.KNN_QUERY_TILE,), n_sm())
        shapes[label] = {"Q": q.shape[0], "M": tt.shape[0], "valid": int(m.sum()), **turns,
                         "bound_ms": sb[0], "bound_by": sb[1], "query_tile": qt, "slices": slices}
        print(f"knn_k at {label} (k={K}, Q={q.shape[0]}, M={tt.shape[0]}, {qt} queries x {slices} slices a "
              f"cluster), marginal CUDA-event ms per launch, medians in turns: "
              + ", ".join(f"{k} {v:.4f}" for k, v in turns.items()) + f"; bound {sb[0]:.4f} ({sb[1]})")
    print(f"knn_k library (cdist + topk at the path's shape): {library_ms:.4f} ms")
    path = shapes["path"]
    return row("knn_k", KNN_SOURCE, "sycl_points_tpu/ops/knn.py:223", "register_pair", err,
               (path["ms"], path["plain_ms"], library_ms), (path["bound_ms"], path["bound_by"]),
               previous_ms=path["previous_ms"], shapes=shapes)


STUDIES = (bench_nn1_tiles, bench_nn1_variants)
# Each study kernel's launch-count key -> (its source, the TPU kernel it
# replaces). The studies' v0 is the production nn1, checked above.
STUDY_KERNELS = {
    "nn1_tiled": (TILES_SOURCE, "scripts/bench_pallas_tiles.py:27"),
    "nn1_tiled_simple": (FIRST_SOURCE, "scripts/bench_pallas_tiles.py:27"),
    "nn1_bias": (VARIANTS_SOURCE, "scripts/bench_nn1_variants.py:106"),
    "nn1_bias_simple": (VARIANTS_SOURCE, "scripts/bench_nn1_variants.py:106"),
    "nn1_lanes": (VARIANTS_SOURCE, "scripts/bench_nn1_variants.py:134"),
    "nn1_lanes_simple": (VARIANTS_SOURCE, "scripts/bench_nn1_variants.py:134"),
    "nn1_unroll2": (VARIANTS_SOURCE, "scripts/bench_nn1_variants.py:168"),
    "nn1_unroll2_simple": (VARIANTS_SOURCE, "scripts/bench_nn1_variants.py:168"),
}


def study_name(module) -> str:
    return module.__name__.rsplit(".", 1)[1]


def check_study_kernels(target, queries, pose) -> list:
    """Every study kernel instance against nn1_plain at the nn1 shape, on the
    queries moved by ``pose``: equal indices and bit-equal distances with
    every 37th target (and the padding) masked, with every target masked, on
    the first odd number of targets (a partial last tile at every tile size,
    an odd tail for the first nn1_unroll2, a masked pad row for the ring's),
    on the target with each row doubled and then repeated (ties inside
    nn1_unroll2's pairs, and twins in other splits: the lowest index must
    win), and with the queries as masked rows ahead of the target (masked
    rows at d = 0 must lose); then its time (median of 3 marginal times). A
    wrapper's row carries its fastest instance."""
    t = target.points
    moved = transform_points(queries, pose).contiguous()
    keep = torch.arange(target.capacity, device=t.device) % MASK_EVERY != 0
    mask = (target.mask & keep).to(torch.uint8)
    n_odd = (target.capacity - 1) | 1
    cases = {"some masked": (t, mask), "all masked": (t, torch.zeros_like(mask)),
             f"first {n_odd} targets": (t[:n_odd], mask[:n_odd]),
             "equal adjacent rows, twins across splits": (t.repeat_interleave(2, 0).repeat(2, 1).contiguous(),
                                                          mask.repeat_interleave(2).repeat(2)),
             "masked rows on the queries": (torch.cat([moved, t]).contiguous(),
                                            torch.cat([torch.zeros_like(mask[: moved.shape[0]]), mask]))}
    refs = {what: cuda_knn.nn1_plain(tt, m, moved) for what, (tt, m) in cases.items()}
    i0, d0 = refs["all masked"]
    if not (bool((i0 == 0).all()) and bool(torch.isinf(d0).all())):
        raise AssertionError("nn1_plain with every target masked must give idx 0, d2 = inf")
    t_inf = inf_masked(t, mask)
    b = nn1_bound(moved.shape[0], target.capacity, int(mask.sum()))
    # plain and library are the same calls for every instance: timed once, in
    # turns with the production nn1
    _, plain_ms, lib_ms = compare_times(
        lambda: cuda_knn.nn1(t, mask, moved), lambda: cuda_knn.nn1_plain(t, mask, moved),
        lambda: cdist_min(moved, t_inf),
    )
    print(f"study kernels at Q={moved.shape[0]} M={target.capacity} (valid {int(mask.sum())}): "
          f"plain {plain_ms:.4f} ms, cdist+min {lib_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]})")
    dev = t.device
    per, study = {name: {} for name in STUDY_KERNELS}, {}
    for module in STUDIES:
        for label, (name, prepare, fn) in module.INSTANCES.items():
            if name not in STUDY_KERNELS:
                continue
            for what, (tt, m) in cases.items():
                idx, d2 = fn(prepare(tt, m), moved)
                torch.cuda.synchronize()
                ri, rd = refs[what]
                bad = int((idx != ri).sum())
                if bad or not torch.equal(d2, rd):
                    raise AssertionError(f"{name} {label} ({what}): {bad} index mismatches, "
                                         f"distances equal: {torch.equal(d2, rd)}")
            target = prepare(t, mask)
            ms = statistics.median(marginal_ms(lambda: fn(target, moved), dev) for _ in range(3))
            per[name][label], study[name] = ms, study_name(module)
            print(f"{name} {label}: equal to nn1_plain ({', '.join(cases)}); kernel {ms:.4f} ms")
    rows = []
    for name, (source, replaces) in STUDY_KERNELS.items():
        best = min(per[name], key=per[name].get)
        rows.append(row(name, source, replaces, study[name], 0.0, (per[name][best], plain_ms, lib_ms), b,
                        instance=best, instance_ms=per[name]))
    return rows


def run_studies(results: list) -> None:
    """Each study entry point at STUDY_SHAPE with the counts set to 0 just
    before it and read just after; every row must equal nn1_plain exactly,
    and every kernel of the study must have launched."""
    for module in STUDIES:
        path = study_name(module)
        names = {name for name, _, _ in module.INSTANCES.values() if name in STUDY_KERNELS}
        cuda_knn.reset_launch_counts()
        rows = module.main(shapes=STUDY_SHAPE)
        torch.cuda.synchronize()
        counts = dict(cuda_knn.launch_counts)
        print(f"{path} launches: {counts}")
        if any(r["agree"] != 1.0 or r["dmax"] != 0.0 for r in rows):
            raise AssertionError(f"{path}: an instance disagrees with nn1_plain")
        if min(counts[n] for n in names) <= 0:
            raise AssertionError(f"a kernel of {path} never launched: {counts}")
        for r in results:
            if r["name"] in names:
                r["launches"] = counts[r["name"]]


def stage_times(src_raw, tgt_raw, cap, runs: int = 5) -> dict:
    """Median wall time (ms) of each stage, synchronizing around each."""
    times = {"preprocess (box+voxel) per scan": [], "self-kNN per scan": [],
             "covariances+normals per scan": [], "align_pipeline": []}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) * 1e3)
        return out

    for i in range(runs + 1):
        clouds = []
        for raw in (src_raw, tgt_raw):
            c = timed("preprocess (box+voxel) per scan", lambda: downsample(raw, VOXEL, cap))
            knn = timed("self-kNN per scan", lambda: self_knn(c.points, c.mask, K))

            def feats():
                covs = estimate_covariances(c.points, knn)
                return c.replace(covs=covs, normals=extract_normals(c.points, covs))

            clouds.append(timed("covariances+normals per scan", feats))
        gen = torch.Generator(device=src_raw.device).manual_seed(SEED)
        timed("align_pipeline", lambda: align_pipeline(
            clouds[0], clouds[1], BruteForceKNN.build(clouds[1]), PAIR_PARAMS, generator=gen))
        if i == 0:  # warm-up round
            for v in times.values():
                v.clear()
    return {name: statistics.median(v) for name, v in times.items()}


def check_small_pair_against_cpu(world, pose_src, pose_tgt, device) -> None:
    """The slice on a 512 x 32 pair, on the card and through the plain
    versions on the CPU, with the same sampling scores: poses within 2 mm and
    0.1 deg of each other."""
    pts = [scan_at(world, pose, n_az=512, n_rings=32, device=device) for pose in (pose_src, pose_tgt)]
    cap = voxel_capacity([cloud_from_numpy(p) for p in pts], VOXEL)
    scores = np.random.default_rng(SEED).gumbel(size=cap).astype(np.float32)
    poses = []
    for dev in (torch.device("cpu"), device):
        src, tgt = (preprocess(cloud_from_numpy(p, device=dev), VOXEL, K, cap) for p in pts)
        out = align_pipeline(src, tgt, BruteForceKNN.build(tgt), PAIR_PARAMS,
                             scores=torch.from_numpy(scores).to(dev))
        poses.append(out.result.T.cpu().numpy())
    trans, rot = pose_error(poses[1], poses[0])
    print(f"small pair (512 x 32), card vs CPU plain path: {trans * 1e3:.4f} mm, {rot:.5f} deg apart")
    if not (trans <= 2e-3 and rot <= 0.1):
        raise AssertionError("the card and the CPU reference disagree on the small pair")


class PlainNN1Search(BruteForceKNN):
    """The ICP loop's correspondence search through nn1_plain."""

    def search(self, query_points, k, pose=None):
        i, d = cuda_knn.nn1_plain(self.points, self.mask, query_points, pose)
        return KNNResult(i[:, None], d[:, None])


def check_pose_bit_exact(src_raw, tgt_raw, cap) -> None:
    """register_pair's stages after the voxel step, on one pair of voxel
    clouds, through the production kernels and through their exact
    references (knn_k_simple for the self-k-NN, nn1_plain for the
    correspondences): the poses must be equal bit for bit. The voxel step
    runs once, as its index_add_ sums in no fixed order."""
    vox = [downsample(raw, VOXEL, cap) for raw in (src_raw, tgt_raw)]
    poses = []
    for knn_fn, search in ((self_knn, BruteForceKNN),
                           (lambda p, m, k: KNNResult(*cuda_knn.knn_k_simple(p, m, p, k)), PlainNN1Search)):
        clouds = []
        for c in vox:
            covs = estimate_covariances(c.points, knn_fn(c.points, c.mask, K))
            clouds.append(c.replace(covs=covs, normals=extract_normals(c.points, covs)))
        gen = torch.Generator(device=c.points.device).manual_seed(SEED)
        out = align_pipeline(clouds[0], clouds[1], search(points=clouds[1].points, mask=clouds[1].mask),
                             PAIR_PARAMS, generator=gen)
        poses.append(out.result.T)
    if not torch.equal(poses[0], poses[1]):
        raise AssertionError(f"the pose through the kernels differs from the pose through their references: "
                             f"{(poses[0] - poses[1]).abs().max().item():.3g}")
    print("register_pair after the voxel step, cluster kernels vs knn_k_simple + nn1_plain: poses equal bit for bit")


def check_on_device(tree, device) -> None:
    for name, value in tree.items():
        if isinstance(value, torch.Tensor) and value.device.type != device.type:
            raise AssertionError(f"{name} lies on {value.device}, not on {device}")


def print_frames(out) -> None:
    for r in out["rows"]:
        print(f"  frame {r['frame']:2d}: {r['result']:<12s} {r['ms']:8.3f} ms, {r['iterations']:2d} iterations, "
              f"{r['inliers']:4d} inliers, keyframe {int(r['keyframe'])}, load {r['load']:.4f} of "
              f"{r['map_capacity']}, target {r['target']}, launches nn1 {r['launches']['nn1']} "
              f"knn_k {r['launches']['knn_k']}, host syncs {r['syncs']}")


def check_replay(name: str, out, n_keyframes_min: int, max_ate: float) -> None:
    bad = [r["frame"] for r in out["rows"][1:] if r["result"] != "success"]
    n_kf = len(out["odometry"].get_keyframe_poses())  # the first frame is the first keyframe
    print(f"{name}: ATE {out['ate_m']:.4f} m over {len(out['rows'])} frames, {n_kf} keyframes (the first frame "
          f"included)")
    if out["rows"][0]["result"] != "first_frame" or bad:
        raise AssertionError(f"{name}: frames {bad} did not succeed")
    if n_kf < n_keyframes_min:
        raise AssertionError(f"{name}: {n_kf} keyframes, fewer than {n_keyframes_min}")
    if not out["ate_m"] <= max_ate:
        raise AssertionError(f"{name}: ATE {out['ate_m']:.4f} m above {max_ate} m")
    if not all(np.isfinite(T).all() for T in out["poses"]):
        raise AssertionError(f"{name}: a pose is not finite")


def launches_after_first(out) -> str:
    """The nn1 / knn_k launches of the frames after the first (the first
    builds its target from the scan), in all and a frame."""
    after = out["rows"][1:]
    n = len(after)
    per = {k: sum(r["launches"][k] for r in after) for k in ("nn1", "knn_k")}
    return f"over the {n} frames after the first: " + ", ".join(
        f"{k} {v} ({v / n:.2f} a frame)" for k, v in per.items())


def median_of(rows, key, pick=lambda r: True):
    vals = [key(r) for r in rows if pick(r)]
    return statistics.median(vals) if vals else float("nan")


def lo_replay(dev) -> dict:
    """The full-width replay: frames, ATE, frame times, launches and syncs a
    frame, and what the kernel checks at the frame's shapes need."""
    t0 = time.perf_counter()
    poses, scans = odometry_replay.make_scans(LO_FRAMES, device=dev)
    params = odometry_replay.replay_params(poses[0])
    print(f"LO replay: {LO_FRAMES} scans of {scans[0].capacity} rays "
          f"({int(scans[0].count())} returns in the first), made in {time.perf_counter() - t0:.2f} s")
    odometry_replay.run_replay(params, poses[:LO_WARMUP + 1], scans[:LO_WARMUP + 1], device=dev)  # warms the allocator
    torch.cuda.synchronize()
    cuda_knn.reset_launch_counts()
    out = odometry_replay.run_replay(params, poses, scans, device=dev)
    torch.cuda.synchronize()
    launches = dict(cuda_knn.launch_counts)
    print_frames(out)
    check_replay("LO replay (2048 x 64, full width)", out, 2, MAX_ATE_M)
    lo = out["odometry"]
    final_t, final_r = pose_error(out["poses"][-1], poses[-1])
    rows = out["rows"][LO_WARMUP:]
    ms = [r["ms"] for r in rows]
    print(f"LO frame after {LO_WARMUP} warm-up frames: median {statistics.median(ms):.3f} ms, max {max(ms):.3f} ms "
          f"(keyframes median {median_of(rows, lambda r: r['ms'], lambda r: r['keyframe']):.3f}, others "
          f"{median_of(rows, lambda r: r['ms'], lambda r: not r['keyframe']):.3f}); final pose error "
          f"{final_t * 100:.3f} cm, {final_r:.4f} deg; map load {rows[-1]['load']:.4f}, "
          f"dropped {int(lo.submap.map_state.dropped)}, budget lost {lo.submap.budget_lost}")
    print(f"LO launches {launches} in all {len(out['rows'])} frames; {launches_after_first(out)}; host syncs a "
          f"frame: median "
          f"{median_of(rows, lambda r: r['syncs'])}, keyframes {median_of(rows, lambda r: r['syncs'], lambda r: r['keyframe'])}, "
          f"others {median_of(rows, lambda r: r['syncs'], lambda r: not r['keyframe'])}")
    if min(launches["nn1"], launches["knn_k"]) <= 0:
        raise AssertionError(f"a kernel of the LO frame never launched: {launches}")
    check_on_device(vars(lo.submap.submap_cloud), dev)
    check_on_device(vars(lo.submap.map_state), dev)
    check_on_device(vars(lo.preprocessed), dev)

    # the split of a frame by stage: a second run whose stages end in a synchronisation
    staged = odometry_replay.run_replay(params, poses, scans, device=dev, sync_stage_times=True)
    srows = staged["rows"][LO_WARMUP:]
    for stage in sorted(srows[-1]["stages_ms"]):
        get = lambda r, stage=stage: r["stages_ms"].get(stage, 0.0)
        print(f"LO stage {stage}: median {median_of(srows, get):.3f} ms, keyframes "
              f"{median_of(srows, get, lambda r: r['keyframe']):.3f}, others "
              f"{median_of(srows, get, lambda r: not r['keyframe']):.3f}")
    print(f"LO frame with synchronised stages: median {statistics.median(r['ms'] for r in srows):.3f} ms, "
          f"ATE {staged['ate_m']:.4f} m")

    # the frame's kernel inputs: the first frame's target and the last one
    first = odometry_replay.run_replay(params, poses[:1], scans[:1], device=dev)["odometry"]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    queries = random_sampling(lo.preprocessed, N_QUERIES, gen).points.contiguous()
    pose = torch.as_tensor(out["poses"][-1], dtype=torch.float32, device=dev).contiguous()
    pose0 = torch.as_tensor(out["poses"][1], dtype=torch.float32, device=dev).contiguous()
    return {"launches": launches, "scan": lo.preprocessed, "queries": queries,
            "targets": {"first frame": (first.submap.submap_cloud, pose0), "last keyframe": (lo.submap.submap_cloud, pose)},
            "replay": (params, poses, scans, out)}


def check_lo_shapes(lo_out, path: str = LO_PATH, tag: str = "LO") -> list:
    """nn1 and knn_k at the odometry frame's shapes: bit-equal to nn1_plain and
    to knn_k_simple (and knn_k_plain in its sets), and timed in turns with
    their plain versions; one row each for the JSON line, at the last of the
    targets (nn1) and the scan's self-search (knn_k)."""
    dev = lo_out["queries"].device
    q = lo_out["queries"]
    rows, shapes = [], {}
    for label, (target, pose) in lo_out["targets"].items():
        t, m = target.points.contiguous(), target.mask.to(torch.uint8)
        for what, (tt, mm) in {"target": (t, m), "all masked": (t, torch.zeros_like(m))}.items():
            check_equal("nn1", cuda_knn.nn1(tt, mm, q, pose), cuda_knn.nn1_plain(tt, mm, q, pose),
                        f"{tag} {label}, {what}")
        pr = cuda_knn.prep_target(t, m)
        check_equal("nn1", cuda_knn.nn1_prepped(pr, q, pose), cuda_knn.nn1_prepped(full_sweep(pr), q, pose),
                    f"{tag} {label}, against the full sweep")
        turns = in_turns({"plain_ms": lambda: cuda_knn.nn1_plain(t, m, q, pose),
                          "ms": lambda: cuda_knn.nn1_prepped(pr, q, pose),
                          "full_sweep_ms": lambda: cuda_knn.nn1_prepped(full_sweep(pr), q, pose)})
        moved = transform_points(q, pose).contiguous()
        lib = marginal_ms(lambda: cdist_min(moved, inf_masked(t, m)), dev)
        sb = nn1_bound(q.shape[0], t.shape[0], int(m.sum()))
        extent = int(pr.extent[0])
        shapes[label] = {"Q": q.shape[0], "M": t.shape[0], "valid": int(m.sum()), "extent": extent, **turns,
                         "library_ms": lib, "bound_ms": sb[0], "bound_by": sb[1]}
        print(f"nn1 at the {tag} frame's shape, {label} target (Q={q.shape[0]}, M={t.shape[0]}, valid {int(m.sum())}, "
              f"extent {extent}): equal to nn1_plain and to the full sweep bit for bit (all masked too); in turns: "
              f"kernel {turns['ms']:.4f} ms, full sweep {turns['full_sweep_ms']:.4f}, plain {turns['plain_ms']:.4f}; "
              f"cdist+min {lib:.4f}, bound {sb[0]:.4f} ({sb[1]})")
    last = shapes[list(shapes)[-1]]
    rows.append(row("nn1", KNN_SOURCE, "sycl_points_tpu/ops/pallas_knn.py:111", path, 0.0,
                    (last["ms"], last["plain_ms"], last["library_ms"]), (last["bound_ms"], last["bound_by"]),
                    shapes=shapes))

    shapes = {}
    clouds = {"scan": lo_out["scan"], "submap target": list(lo_out["targets"].values())[-1][0]}
    for label, cloud in clouds.items():
        pts, mask = cloud.points.contiguous(), cloud.mask
        got = cuda_knn.knn_k(pts, mask, pts, K)
        check_equal("knn_k", got, cuda_knn.knn_k_simple(pts, mask, pts, K), f"{tag} {label}")
        check_equal("knn_k", cuda_knn.knn_k(pts, torch.zeros_like(mask), pts, K),
                    cuda_knn.knn_k_simple(pts, torch.zeros_like(mask), pts, K), f"{tag} {label}, all masked")
        ref = cuda_knn.knn_k_plain(pts, mask, pts, K)
        torch.cuda.synchronize()
        bad, err = cuda_knn.knn_mismatches(*got, *ref, TIE_TOL), finite_max_abs_err(got[1], ref[1])
        if bad or err > D2_ATOL:
            raise AssertionError(f"knn_k disagrees with its plain version at the {tag} {label}'s shape")
        pr = cuda_knn.prep_target(pts, mask)
        check_equal("knn_k", got, cuda_knn.knn_k_prepped(full_sweep(pr), pts, K), f"{tag} {label}, full sweep")
        turns = in_turns({"plain_ms": lambda: cuda_knn.knn_k_plain(pts, mask, pts, K),
                          "ms": lambda: cuda_knn.knn_k_prepped(pr, pts, K),
                          "full_sweep_ms": lambda: cuda_knn.knn_k_prepped(full_sweep(pr), pts, K),
                          "public_ms": lambda: cuda_knn.knn_k(pts, mask, pts, K)})
        t_inf = inf_masked(pts, mask)
        lib = marginal_ms(lambda: torch.cdist(pts, t_inf, compute_mode="donot_use_mm_for_euclid_dist")
                          .topk(K, largest=False), dev)
        n = pts.shape[0]
        sb = knn_bound(n, n, int(mask.sum()), K)
        extent = int(pr.extent[0])
        shapes[label] = {"Q": n, "M": n, "valid": int(mask.sum()), "extent": extent, **turns, "library_ms": lib,
                         "max_abs_err": err, "bound_ms": sb[0], "bound_by": sb[1]}
        print(f"knn_k at the {tag} frame's shape, {label} (k={K}, Q=M={n}, valid {int(mask.sum())}, extent {extent}): "
              f"equal to knn_k_simple and to the full sweep bit for bit (all masked too), max |d2 - plain| = "
              f"{err:.3g}; in turns: kernel {turns['ms']:.4f} ms, full sweep {turns['full_sweep_ms']:.4f}, with prep "
              f"{turns['public_ms']:.4f}, plain {turns['plain_ms']:.4f}; cdist+topk {lib:.4f}, bound {sb[0]:.4f} "
              f"({sb[1]})")
    scan = shapes["scan"]
    rows.append(row("knn_k", KNN_SOURCE, "sycl_points_tpu/ops/knn.py:223", path, scan["max_abs_err"],
                    (scan["ms"], scan["plain_ms"], scan["library_ms"]), (scan["bound_ms"], scan["bound_by"]),
                    shapes=shapes))
    for r in rows:
        r["launches"] = lo_out["launches"][r["name"]]
    return rows


def small_replays(dev) -> None:
    """Map growth on the card, and the card against the CPU, on 512 x 32
    scans."""
    n_az, n_rings = SMALL_RAYS
    poses, scans = odometry_replay.make_scans(GROWTH_FRAMES, n_az, n_rings, device=dev)
    out = odometry_replay.run_replay(odometry_replay.replay_params(poses[0], *GROWTH_CAPACITIES), poses, scans,
                                     device=dev)
    torch.cuda.synchronize()
    print_frames(out)
    check_replay(f"growth replay ({n_az} x {n_rings}, from {GROWTH_CAPACITIES[0]} slots)", out, 2, MAX_ATE_M)
    sm = out["odometry"].submap
    print(f"growth replay: map {GROWTH_CAPACITIES[0]} -> {sm.map_capacity} slots, target {GROWTH_CAPACITIES[1]} -> "
          f"{sm.extract_capacity} rows, dropped {int(sm.map_state.dropped)}, extract overflow {sm.extract_overflow}")
    if sm.map_capacity <= GROWTH_CAPACITIES[0]:
        raise AssertionError("the map never grew")
    if int(sm.map_state.dropped) or sm.extract_overflow:
        raise AssertionError("contributions were dropped, or the target is truncated")

    finals = {}
    for device in (torch.device("cpu"), dev):
        p, s = odometry_replay.make_scans(CPU_FRAMES, n_az, n_rings, device=device)
        o = odometry_replay.run_replay(odometry_replay.replay_params(p[0]), p, s, device=device)
        check_replay(f"{CPU_FRAMES}-frame replay on {device.type}", o, 2, MAX_ATE_M)
        finals[device.type] = o["poses"][-1]
    trans, rot = pose_error(finals["cuda"], finals["cpu"])
    print(f"card vs CPU plain path after {CPU_FRAMES} frames ({n_az} x {n_rings}): {trans * 1e3:.3f} mm, "
          f"{rot:.5f} deg apart")
    if not (trans <= CPU_TRANS_M and rot <= CPU_ROT_DEG):
        raise AssertionError("the card and the CPU disagree on the small replay")


def print_lio_frames(out) -> None:
    for r in out["rows"]:
        print(f"  frame {r['frame']:2d}: {r['result']:<12s} {r['ms']:8.3f} ms, {r['iterations']:2d} iterations, "
              f"keyframe {int(r['keyframe'])}, launches nn1 {r['launches']['nn1']} knn_k {r['launches']['knn_k']}, "
              f"host syncs {r['syncs']}")


def check_lio(name: str, out, max_ate: float) -> None:
    bad = [r["frame"] for r in out["rows"][1:] if r["result"] != "success"]
    print(f"{name}: ATE {out['ate_m']:.4f} m over {len(out['rows'])} frames (bound {max_ate} m), final bias errors "
          f"gyro {out['gyro_bias_err']:.6f} rad/s, accel {out['accel_bias_err']:.6f} m/s^2, "
          f"{len(out['odometry'].get_keyframe_poses())} keyframes, {out['map_voxels']} map voxels")
    if out["rows"][0]["result"] != "first_frame" or bad:
        raise AssertionError(f"{name}: frames {bad} did not succeed")
    if not out["ate_m"] <= max_ate:
        raise AssertionError(f"{name}: ATE {out['ate_m']:.4f} m above {max_ate} m")
    if not all(np.isfinite(T).all() for T in out["poses"]):
        raise AssertionError(f"{name}: a pose is not finite")


def lio_replay_phase(dev) -> dict:
    """The full-width LIO replay: frames, ATE, bias errors, frame times,
    launches and syncs a frame, the stage split, and what the kernel checks
    at the frame's shapes need."""
    t0 = time.perf_counter()
    inputs = lio_replay.make_lio_inputs(LIO_FRAMES, device=dev)
    params = lio_replay.lio_params(inputs.poses[0])
    print(f"LIO replay: {LIO_FRAMES} scans of {inputs.scans[0].capacity} rays ({int(inputs.scans[0].count())} "
          f"returns in the first) and a {odometry_replay.IMU_HZ} Hz IMU, made in {time.perf_counter() - t0:.2f} s")
    lio_replay.run_lio_replay(params, inputs._replace(scans=inputs.scans[:LIO_WARMUP + 1],
                                                      poses=inputs.poses[:LIO_WARMUP + 1]), device=dev)
    torch.cuda.synchronize()
    cuda_knn.reset_launch_counts()
    out = lio_replay.run_lio_replay(params, inputs, device=dev)
    torch.cuda.synchronize()
    launches = dict(cuda_knn.launch_counts)
    print_lio_frames(out)
    check_lio("LIO replay (2048 x 64, full width)", out, MAX_LIO_ATE_M)
    odo = out["odometry"]
    rows = out["rows"][LIO_WARMUP:]
    ms = [r["ms"] for r in rows]
    final_t, final_r = pose_error(out["poses"][-1], inputs.poses[-1])
    print(f"LIO frame after {LIO_WARMUP} warm-up frames: median {statistics.median(ms):.3f} ms, max {max(ms):.3f} ms "
          f"(keyframes median {median_of(rows, lambda r: r['ms'], lambda r: r['keyframe']):.3f}, others "
          f"{median_of(rows, lambda r: r['ms'], lambda r: not r['keyframe']):.3f}); iterations a frame median "
          f"{median_of(rows, lambda r: r['iterations'])}; final pose error {final_t * 100:.3f} cm, {final_r:.4f} deg")
    print(f"LIO launches {launches} in all {len(out['rows'])} frames; {launches_after_first(out)}; host syncs a "
          f"frame: median "
          f"{median_of(rows, lambda r: r['syncs'])}, max {max(r['syncs'] for r in rows)}")
    if min(launches["nn1"], launches["knn_k"]) <= 0:
        raise AssertionError(f"a kernel of the LIO frame never launched: {launches}")
    check_on_device(odo.get_state()._asdict(), dev)
    check_on_device({"P_post": odo.P_post}, dev)
    check_on_device(vars(odo.preprocessed), dev)

    staged = lio_replay.run_lio_replay(params, inputs, device=dev, sync_stage_times=True)
    srows = staged["rows"][LIO_WARMUP:]
    for stage in sorted(srows[-1]["stages_ms"]):
        get = lambda r, stage=stage: r["stages_ms"].get(stage, 0.0)
        print(f"LIO stage {stage}: median {median_of(srows, get):.3f} ms, keyframes "
              f"{median_of(srows, get, lambda r: r['keyframe']):.3f}, others "
              f"{median_of(srows, get, lambda r: not r['keyframe']):.3f}")
    print(f"LIO frame with synchronised stages: median {statistics.median(r['ms'] for r in srows):.3f} ms, "
          f"ATE {staged['ate_m']:.4f} m")

    first = lio_replay.run_lio_replay(params, inputs._replace(scans=inputs.scans[:1], poses=inputs.poses[:1]),
                                      device=dev)["odometry"]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    queries = random_sampling(odo.preprocessed, N_QUERIES, gen).points.contiguous()
    pose = torch.as_tensor(out["poses"][-1], dtype=torch.float32, device=dev).contiguous()
    pose0 = torch.as_tensor(out["poses"][1], dtype=torch.float32, device=dev).contiguous()
    return {"launches": launches, "scan": odo.preprocessed, "queries": queries,
            "targets": {"first frame": (first.submap.submap_cloud, pose0),
                        "last keyframe": (odo.submap.submap_cloud, pose)},
            "replay": (params, inputs, out)}


def cpu_sized(params):
    """``params`` on the map and target sizes of the card-vs-CPU replays."""
    return dataclasses.replace(params, submap=dataclasses.replace(
        params.submap, map_capacity=LIO_CPU_CAPACITIES[0], extract_capacity=LIO_CPU_CAPACITIES[1]))


def every_point(params):
    """``params`` with every sampling stage taking all the points."""
    down = dataclasses.replace(params.scan.downsampling, random=dataclasses.replace(
        params.scan.downsampling.random, enable=False))
    return dataclasses.replace(
        params, scan=dataclasses.replace(params.scan, downsampling=down),
        registration_sampling=dataclasses.replace(params.registration_sampling, enable=False),
        submap=dataclasses.replace(params.submap, point_random_sampling_num=params.scan_capacity))


def small_lio_replays(dev) -> None:
    """IMU deskew on distorted sweeps, LidarOdometry with the IMU, bias
    recovery on the 3-D-excited figure-8, and the card against the CPU, on
    512 x 32 scans."""
    n_az, n_rings = SMALL_RAYS
    inputs = lio_replay.make_lio_inputs(DESKEW_FRAMES, n_az, n_rings, speed=DESKEW_SPEED, distort=True, device=dev)
    ate = {}
    for deskew in (True, False):
        out = lio_replay.run_lio_replay(lio_replay.lio_params(inputs.poses[0], deskew=deskew), inputs, device=dev)
        name = f"distorted LIO replay ({n_az} x {n_rings}, {DESKEW_SPEED} m a frame), deskew {'on' if deskew else 'off'}"
        check_lio(name, out, float("inf"))
        ate[deskew] = out["ate_m"]
        if deskew:
            print(f"deskew on: invented gyro bias {out['gyro_bias_err']:.6f} rad/s")
    print(f"deskew on / off ATE: {ate[True] / ate[False]:.4f} (bound {DESKEW_GAIN})")
    if not (ate[True] <= MAX_DESKEW_ATE_M and ate[True] <= DESKEW_GAIN * ate[False]):
        raise AssertionError(f"deskew on: ATE {ate[True]:.4f} m, off: {ate[False]:.4f} m "
                             f"(on must be <= {MAX_DESKEW_ATE_M} m and <= {DESKEW_GAIN} x off)")

    inputs = lio_replay.make_lio_inputs(LO_IMU_FRAMES, n_az, n_rings, device=dev)
    params = dataclasses.replace(odometry_replay.replay_params(inputs.poses[0]),
                                 imu=lio_replay.lio_params(inputs.poses[0]).imu,
                                 motion_prediction=MotionPredictionParams(mode="IMU_SE3"))
    out = odometry_replay.run_replay(params, inputs.poses, inputs.scans, device=dev, imu=inputs.imu)
    torch.cuda.synchronize()
    print_frames(out)
    check_replay(f"LO with the IMU, IMU_SE3 ({n_az} x {n_rings})", out, 1, MAX_ATE_M)

    inputs = lio_replay.make_lio_inputs(BIAS_FRAMES, n_az, n_rings, excite3d=True, gyro_bias=GYRO_BIAS,
                                        accel_bias=ACCEL_BIAS, device=dev)
    out = lio_replay.run_lio_replay(lio_replay.lio_params(inputs.poses[0], *BIAS_RW), inputs, device=dev)
    check_lio(f"3-D-excited LIO replay with injected biases ({n_az} x {n_rings}, {BIAS_FRAMES} frames)", out,
              MAX_BIAS_ATE_M)
    g0, a0 = float(np.linalg.norm(GYRO_BIAS)), float(np.linalg.norm(ACCEL_BIAS))
    g_rec, a_rec = 1 - out["gyro_bias_err"] / g0, 1 - out["accel_bias_err"] / a0
    print(f"bias recovery: gyro {g0:.4f} -> {out['gyro_bias_err']:.4f} rad/s ({g_rec:.1%} recovered, bound "
          f"{MIN_GYRO_RECOVERED:.0%}), accel {a0:.4f} -> {out['accel_bias_err']:.4f} m/s^2 ({a_rec:.1%} recovered, "
          f"bound above 0%)")
    for key, true in (("gyro_bias", GYRO_BIAS), ("accel_bias", ACCEL_BIAS)):
        errs = [float(np.linalg.norm(np.subtract(r[key], true))) for r in out["rows"][::30]]
        print(f"  {key} error every 30 frames: " + ", ".join(f"{e:.4f}" for e in errs))
    if not (g_rec >= MIN_GYRO_RECOVERED and a_rec > 0):
        raise AssertionError("the filter did not recover the injected biases")

    # The LIO filter follows its sampled points, so the card against the CPU
    # takes every point; the sampled runs show the spread sampling makes.
    finals = {}
    for device in (torch.device("cpu"), dev):
        inp = lio_replay.make_lio_inputs(LIO_CPU_FRAMES, n_az, n_rings, device=device)
        o = lio_replay.run_lio_replay(cpu_sized(every_point(lio_replay.lio_params(inp.poses[0]))), inp,
                                      device=device)
        check_lio(f"{LIO_CPU_FRAMES}-frame LIO replay on {device.type}, every point", o, MAX_LIO_ATE_M)
        finals[device.type] = o["poses"][-1]
    trans, rot = pose_error(finals["cuda"], finals["cpu"])
    print(f"LIO card vs CPU plain path after {LIO_CPU_FRAMES} frames ({n_az} x {n_rings}, every point): "
          f"{trans * 1e3:.3f} mm, {rot:.5f} deg apart (bound {LIO_CPU_TRANS_M * 1e3:.0f} mm, {LIO_CPU_ROT_DEG} deg)")
    if not (trans <= LIO_CPU_TRANS_M and rot <= LIO_CPU_ROT_DEG):
        raise AssertionError("the card and the CPU disagree on the small LIO replay")
    sampled = {}
    for device, seed in ((torch.device("cpu"), None), (dev, None)) + tuple((dev, s) for s in SAMPLING_SEEDS):
        inp = lio_replay.make_lio_inputs(SAMPLED_FRAMES, n_az, n_rings, device=device)
        o = lio_replay.run_lio_replay(cpu_sized(lio_replay.lio_params(inp.poses[0])), inp, device=device, seed=seed)
        check_lio(f"{SAMPLED_FRAMES}-frame LIO replay on {device.type}, sampling seed {seed or 'fixed'}", o,
                  MAX_LIO_ATE_M)
        sampled[f"{device.type}/{seed or 'fixed'}"] = o["poses"][-1]
    names = list(sampled)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            trans, rot = pose_error(sampled[a], sampled[b])
            print(f"LIO final poses after {SAMPLED_FRAMES} sampled frames ({n_az} x {n_rings}), {a} vs {b}: "
                  f"{trans * 1e3:.3f} mm, {rot:.5f} deg apart")


def og_replay(dev) -> dict:
    """The full-width replay at the parameter tree's defaults: frames, ATE,
    inserts, map growth, frame times, launches and syncs a frame, the stage
    split, and what the kernel checks at the path's shapes need."""
    t0 = time.perf_counter()
    poses, scans = odometry_replay.make_scans(LO_FRAMES, device=dev, intensities=True)
    print(f"OG replay: the LO phase's {LO_FRAMES} scans with raw return intensities, made in "
          f"{time.perf_counter() - t0:.2f} s")
    params = odometry_replay.default_params(poses[0])
    odometry_replay.run_replay(params, poses[:LO_WARMUP + 1], scans[:LO_WARMUP + 1], device=dev)
    torch.cuda.synchronize()
    cuda_knn.reset_launch_counts()
    out = odometry_replay.run_replay(params, poses, scans, device=dev)
    torch.cuda.synchronize()
    launches = dict(cuda_knn.launch_counts)
    for r in out["rows"]:
        print(f"  frame {r['frame']:2d}: {r['result']:<12s} {r['ms']:8.3f} ms, {r['iterations']:2d} iterations, "
              f"{r['inliers']:4d} inliers, inserted {int(r['keyframe'])}, {r['voxels']} of {r['map_capacity']} "
              f"slots used, {r['occupied']} occupied, target {r['target']}, launches nn1 {r['launches']['nn1']} "
              f"knn_k {r['launches']['knn_k']}, host syncs {r['syncs']}")
    lo = out["odometry"]
    st = lo.submap.map_state
    after = out["rows"][1:]
    n_inserts = sum(r["keyframe"] for r in after)
    bad = [r["frame"] for r in after if r["result"] != "success"]
    rows = out["rows"][LO_WARMUP:]
    ms = [r["ms"] for r in rows]
    final_t, final_r = pose_error(out["poses"][-1], poses[-1])
    pre = lo.preprocessed
    ic = params.scan.intensity_correction
    inten = None if pre.intensities is None else pre.intensities[pre.mask]
    print(f"OG replay (2048 x 64, default tree): ATE {out['ate_m']:.4f} m over {len(out['rows'])} frames; inserts on "
          f"{n_inserts} of {len(after)} frames after the first; slots used {out['rows'][0]['voxels']} -> "
          f"{rows[-1]['voxels']}, occupied {out['rows'][0]['occupied']} -> {rows[-1]['occupied']}, map capacity "
          f"{lo.submap.map_capacity}; target {after[0]['target']} -> {rows[-1]['target']} valid rows of "
          f"{lo.submap.extract_capacity}")
    print(f"OG frame after {LO_WARMUP} warm-up frames: median {statistics.median(ms):.3f} ms, max {max(ms):.3f} ms; "
          f"final pose error {final_t * 100:.3f} cm, {final_r:.4f} deg; dropped {int(st.dropped)}, budget lost "
          f"{int(st.budget_lost)}, clamped rays {int(st.clamped_rays)}, truncated rays {int(st.truncated_rays)}")
    print(f"OG launches {launches} in all {len(out['rows'])} frames; {launches_after_first(out)}; host syncs a "
          f"frame: median {median_of(rows, lambda r: r['syncs'])}, max {max(r['syncs'] for r in rows)}")
    if out["rows"][0]["result"] != "first_frame" or bad:
        raise AssertionError(f"OG replay: frames {bad} did not succeed")
    if not out["ate_m"] <= MAX_ATE_M or not all(np.isfinite(T).all() for T in out["poses"]):
        raise AssertionError(f"OG replay: ATE {out['ate_m']:.4f} m above {MAX_ATE_M} m, or a pose not finite")
    if n_inserts < OG_MIN_INSERTS:
        raise AssertionError(f"OG replay: inserts on {n_inserts} frames, fewer than {OG_MIN_INSERTS}")
    if rows[-1]["target"] < OG_MIN_TARGET:
        raise AssertionError(f"OG replay: the last target has {rows[-1]['target']} rows, fewer than {OG_MIN_TARGET}")
    if inten is None or not bool(((inten >= ic.min_intensity) & (inten <= ic.max_intensity)).all()):
        raise AssertionError("OG replay: the last scan's intensities are missing or were not corrected")
    print(f"OG last scan: {inten.numel()} corrected intensities, mean {float(inten.mean()):.4f}, in "
          f"[{float(inten.min()):.4f}, {float(inten.max()):.4f}]")
    if min(launches["nn1"], launches["knn_k"]) <= 0:
        raise AssertionError(f"a kernel of the OG frame never launched: {launches}")
    check_on_device(vars(lo.submap.submap_cloud), dev)
    check_on_device(vars(st), dev)
    check_on_device(vars(pre), dev)

    staged = odometry_replay.run_replay(params, poses, scans, device=dev, sync_stage_times=True)
    srows = staged["rows"][LO_WARMUP:]
    for stage in sorted(srows[-1]["stages_ms"]):
        print(f"OG stage {stage}: median {median_of(srows, lambda r, stage=stage: r['stages_ms'].get(stage, 0.0)):.3f} ms")
    print(f"OG frame with synchronised stages: median {statistics.median(r['ms'] for r in srows):.3f} ms, "
          f"ATE {staged['ate_m']:.4f} m")

    pose = torch.as_tensor(out["poses"][-1], dtype=torch.float32, device=dev).contiguous()
    og_step_split(lo, pose)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    queries = random_sampling(pre, N_QUERIES, gen).points.contiguous()
    return {"launches": launches, "scan": pre, "queries": queries,
            "targets": {"last (warm)": (lo.submap.submap_cloud, pose)},
            "replay": (params, poses, scans, out)}


def host_ms(fn, runs: int = 5) -> tuple[float, int]:
    """Median host-clock ms of ``fn()`` between two synchronisations, and
    the host syncs of one call."""
    times = []
    for _ in range(runs + 1):
        torch.cuda.synchronize()
        syncs = sync.counts["host_syncs"]
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        syncs = sync.counts["host_syncs"] - syncs
    return statistics.median(times[1:]), syncs


def og_step_split(lo, pose) -> None:
    """The default tree's submap step (stage 4a) and its parts, each timed
    alone on the last frame's registration input and pose against the warm
    map and target: the robust sampling weights (an nn1 against the target),
    the mixed sampler, the insert and its carve, miss merge and two resolves,
    the extraction, the target's finalize."""
    submap, p = lo.submap, lo.params
    cfg, st, target, knn = submap.map_config, submap.map_state, submap.submap_cloud, submap.submap_knn
    deskewed = align_pipeline(lo.preprocessed, target, knn, lo.pipeline_params, initial_guess=pose).deskewed
    n_desk = int(deskewed.count())
    gen = torch.Generator(device=pose.device).manual_seed(SEED)
    num, ratio = p.submap.point_random_sampling_num, p.submap.weighted_sampling_ratio
    weights = lambda: compute_icp_robust_weights(deskewed, target, knn, pose, p.registration.factor,
                                                 lo._submap_robust_scale)
    w = weights()
    sampled = mixed_sampling(deskewed, num, w, gen, ratio)
    pts = transform_points(sampled.points, pose)
    coords, ok = voxel_coords(pts, sampled.mask, cfg.voxel_size)
    carve = lambda: og._ray_carve_keys(pose[:3, 3], pts, ok, cfg.voxel_size, cfg.ray_axis_budget,
                                       cfg.max_ray_distance)
    keys, _, _, base, B, *_ = carve()
    merged = og._merge_miss_keys(keys.reshape(-1), cfg.miss_merge_budget, B, base)
    seg_keys, agg, _ = vhm._segments(torch.cat([pts, torch.ones_like(pts[:, :1])], 1), coords, ok)
    cnt = agg[:, -1]
    parts = {
        "submap step (all of stage 4a's work)":
            lambda: lo._submap_step(st, target, deskewed, pose, True, gen, knn_prev=knn, n_desk=n_desk),
        "sampling weights (nn1 against the target)": weights,
        "mixed sampling": lambda: mixed_sampling(deskewed, num, w, gen, ratio),
        "insert_extract": lambda: submap.insert_extract(st, sampled, pose),
        "add_point_cloud": lambda: og.add_point_cloud(st, cfg, sampled, pose),
        "carve keys": carve,
        "miss merge": lambda: og._merge_miss_keys(keys.reshape(-1), cfg.miss_merge_budget, B, base),
        "resolve, hits": lambda: resolve_slots(st.coords, st.used, seg_keys, cnt > 0, cfg.capacity, cfg.max_probes),
        "resolve, misses (tiered)": lambda: resolve_slots_tiered(st.coords, st.used, merged[0], merged[1] > 0,
                                                                 cfg.capacity, cfg.max_probes),
        "extract occupied": lambda: submap._extract(st, pose[:3, 3]),
        "finalize target (self-k-NN, covariances)":
            lambda: submap.finalize_traced(target.replace(covs=None, normals=None)),
    }
    n_keys = int((keys != 2**31 - 1).sum())
    print(f"OG submap step split on the last frame ({n_desk} registration points sampled to {int(sampled.count())}, "
          f"{n_keys} carve keys, {int((merged[1] > 0).sum())} unique missed voxels, {int((cnt > 0).sum())} hit "
          f"voxels; host clock between synchronisations, median of 5):")
    for name, fn in parts.items():
        ms, syncs = host_ms(fn)
        print(f"  {name}: {ms:.3f} ms, {syncs} host syncs")


def moved(cloud, device):
    return cloud.replace(**{k: v.to(device) for k, v in vars(cloud).items() if isinstance(v, torch.Tensor)})


def map_as_set(state) -> dict:
    """voxel coordinates -> log-odds, on the host."""
    used = state.used.cpu().numpy()
    return dict(zip(map(tuple, state.coords.cpu().numpy()[used]), state.log_odds.cpu().numpy()[used]))


def check_maps(what: str, a: dict, b: dict) -> None:
    """The CPU's map ``a`` and the card's ``b`` equal as sets, log-odds to
    OG_CPU_LOG_ODDS_ATOL, on all but OG_CPU_MAP_SHARE of their voxels."""
    only = len(a.keys() ^ b.keys())
    log_odds = sum(abs(float(a[k]) - float(b[k])) > OG_CPU_LOG_ODDS_ATOL for k in a.keys() & b.keys())
    n = len(a.keys() | b.keys())
    print(f"{what}: maps {len(a)} / {len(b)} voxels, {only} in one only, {log_odds} with log-odds more than "
          f"{OG_CPU_LOG_ODDS_ATOL} apart ({(only + log_odds) / n:.4%} of {n}, bound {OG_CPU_MAP_SHARE:.0%})")
    if only + log_odds > OG_CPU_MAP_SHARE * n:
        raise AssertionError(f"{what}: the card's and the CPU's maps differ on more voxels than the bound")


def og_first_frame(params, pose, scan, dev) -> None:
    """The default tree's first-frame preprocessing (polar grid, angle of
    incidence, intensity correction) on the CPU and on the card, and the
    CPU's refined cloud inserted into the occupancy grid on both."""
    def refined(device):
        pc = PCProcessor(params, device=device)
        pre = pc.prefilter(moved(scan, device))
        ctx = pc.prepare_context(pre)
        return moved(pc.refine_filter(pc.compute_covariances(pre, ctx), ctx), "cpu")

    a, b = refined(torch.device("cpu")), refined(dev)
    both = a.mask & b.mask
    ia, ib = a.intensities[both], b.intensities[both]
    rel = float(((ia - ib).abs() / ia.abs().clamp_min(1e-30)).max())
    print(f"default tree, first frame card vs CPU: the refine filter keeps {int((a.mask != b.mask).sum())} of "
          f"{int(a.mask.sum())} points on one side only; corrected intensities of the {int(both.sum())} kept by "
          f"both: largest relative difference {rel:.3g} (bound {OG_INTENSITY_RTOL})")
    if not torch.allclose(ia, ib, rtol=OG_INTENSITY_RTOL, atol=0.0):
        raise AssertionError("the card's and the CPU's corrected intensities disagree")
    cfg = Submap(params, device="cpu").og_config
    T = torch.from_numpy(np.asarray(pose, np.float32))
    maps = [map_as_set(og.add_point_cloud(og.create(cfg, d), cfg, moved(a, d), T.to(d)))
            for d in (torch.device("cpu"), dev)]
    check_maps("the CPU's refined first frame inserted on the CPU and on the card", *maps)


def og_small_replays(dev) -> None:
    """The LIO frame at the default trees, and the default tree's card
    against its CPU, on 512 x 32 scans with intensities."""
    n_az, n_rings = SMALL_RAYS
    inputs = lio_replay.make_lio_inputs(OG_LIO_FRAMES, n_az, n_rings, device=dev, intensities=True)
    out = lio_replay.run_lio_replay(lio_replay.lio_params(inputs.poses[0], default_trees=True), inputs, device=dev)
    print_lio_frames(out)
    check_lio(f"LIO replay at the default scan and submap trees ({n_az} x {n_rings})", out, MAX_ATE_M)
    if not (out["gyro_bias_err"] <= OG_MAX_BIAS_ERR[0] and out["accel_bias_err"] <= OG_MAX_BIAS_ERR[1]):
        raise AssertionError(f"LIO at the default trees: bias errors above {OG_MAX_BIAS_ERR}")
    if out["odometry"].preprocessed.intensities is None:
        raise AssertionError("LIO at the default trees: the scan lost its intensities")

    # one set of scans, raycast on the card, for both sides
    poses, scans = odometry_replay.make_scans(OG_CPU_FRAMES, n_az, n_rings, device=dev, intensities=True)
    og_first_frame(every_point(odometry_replay.default_params(poses[0])), poses[0], scans[0], dev)
    on = {dev.type: scans, "cpu": [moved(c, "cpu") for c in scans]}
    finals, maps = {}, {}
    for device in (torch.device("cpu"), dev):
        o = odometry_replay.run_replay(cpu_sized(every_point(odometry_replay.default_params(poses[0]))), poses,
                                       on[device.type], device=device)
        check_replay(f"{OG_CPU_FRAMES}-frame default-tree replay on {device.type}, every point", o, 1, MAX_ATE_M)
        finals[device.type] = o["poses"][-1]
        maps[device.type] = map_as_set(o["odometry"].submap.map_state)
    trans, rot = pose_error(finals["cuda"], finals["cpu"])
    print(f"default tree, card vs CPU plain path after {OG_CPU_FRAMES} frames ({n_az} x {n_rings}, every point): "
          f"{trans * 1e3:.3f} mm, {rot:.5f} deg apart (bound {LIO_CPU_TRANS_M * 1e3:.0f} mm, {LIO_CPU_ROT_DEG} deg)")
    if not (trans <= LIO_CPU_TRANS_M and rot <= LIO_CPU_ROT_DEG):
        raise AssertionError("the card and the CPU disagree on the default-tree replay")
    check_maps(f"default tree, card vs CPU after {OG_CPU_FRAMES} frames", maps["cpu"], maps["cuda"])


def valid_points(cloud, with_intensities: bool = False) -> dict:
    """A cloud's valid rows on the host, as a sensor message carries them."""
    m = cloud.mask
    out = {"points": cloud.points[m].cpu().numpy()}
    if with_intensities and cloud.intensities is not None:
        out["intensities"] = cloud.intensities[m].cpu().numpy()
    return out


def print_pipelined(tag: str, out, sync_out) -> None:
    """Every pipelined frame, then its ms beside the synchronous frame's of
    the same call, host reads a frame by source, blocking fetches, the window
    and launches a frame after the first."""
    rows = out["rows"]
    for r in rows:
        print(f"  frame {r['frame']:2d}: {r['result']:<12s} {r['ms']:8.3f} ms, launches nn1 {r['launches']['nn1']} "
              f"knn_k {r['launches']['knn_k']}, host reads {sum(r['reads'].values())}, blocking fetches "
              f"{r['blocking']}, in flight {r['in_flight']}")
    after = rows[1:]
    n = len(after)
    warm = [r["ms"] for r in rows[LO_WARMUP:]]
    sync_warm = [r["ms"] for r in sync_out["rows"][LO_WARMUP:]]
    print(f"{tag} pipelined frame after {LO_WARMUP} warm-up frames (host clock, no drain between frames): median "
          f"{statistics.median(warm):.3f} ms, max {max(warm):.3f} ms, flush {out['flush_ms']:.3f} ms; the "
          f"synchronous frame in this call: median {statistics.median(sync_warm):.3f} ms, max {max(sync_warm):.3f} ms")
    for what, rs in (("pipelined", after), ("synchronous", sync_out["rows"][1:])):
        reads = {}
        for r in rs:
            for src, k in r["reads"].items():
                reads[src] = reads.get(src, 0) + k
        print(f"{tag} {what} host reads a frame after the first ({sum(reads.values()) / len(rs):.2f} in all): "
              + ", ".join(f"{src} {k / len(rs):.2f}" for src, k in sorted(reads.items(), key=lambda kv: -kv[1])))
    odo = out["odometry"]
    depths = {d: sum(r["in_flight"] == d for r in rows) for d in sorted({r["in_flight"] for r in rows})}
    print(f"{tag} pipelined: blocking fetches {sum(r['blocking'] for r in rows)} in {len(rows)} frames; frames left "
          f"in flight when a call returned: {depths} (frames a depth), at most {odo.in_flight_peak} of "
          f"{odo.max_in_flight}; launches a frame after the first: nn1 "
          f"{sum(r['launches']['nn1'] for r in after) / n:.2f}, knn_k "
          f"{sum(r['launches']['knn_k'] for r in after) / n:.2f}"
          f" (synchronous: {launches_after_first(sync_out)})")


def check_pipelined(tag: str, out, sync_out, truth, max_ate: float, trans_m: float, rot: float | None) -> None:
    """Every deferred result a success, a resolved pose for every frame
    after the first, the ATE, every pose within the bounds of the
    synchronous run's, nothing dropped."""
    odo = out["odometry"]
    n = len(truth)
    gaps = [(float(np.abs(a[:3, 3] - b[:3, 3]).max()), float(np.abs(a[:3, :3] - b[:3, :3]).max()))
            for a, b in zip(out["poses"], sync_out["poses"], strict=True)]
    worst_t, worst_r = max(g[0] for g in gaps), max(g[1] for g in gaps)
    print(f"{tag} pipelined: {len(odo.pose_log)} resolved poses, ATE {out['ate_m']:.4f} m (bound {max_ate} m; "
          f"synchronous {sync_out['ate_m']:.4f}); apart from the synchronous run by at most {worst_t * 1e3:.3f} mm "
          f"(bound {trans_m * 1e3:.0f} mm), rotation entries {worst_r:.2e}"
          + (f" (bound {rot})" if rot is not None else "") + f"; dropped {int(odo.submap.map_state.dropped)}")
    if out["results"] != ["success"] * (n - 1) or len(odo.pose_log) != n - 1:
        raise AssertionError(f"{tag} pipelined: deferred results {out['results']}")
    if not out["ate_m"] <= max_ate or not all(np.isfinite(T).all() for T in out["poses"]):
        raise AssertionError(f"{tag} pipelined: ATE {out['ate_m']:.4f} m above {max_ate} m, or a pose not finite")
    if worst_t > trans_m or (rot is not None and worst_r > rot):
        raise AssertionError(f"{tag} pipelined: a pose is farther from the synchronous run's than the bounds")
    if int(odo.submap.map_state.dropped):
        raise AssertionError(f"{tag} pipelined: contributions were dropped")


def pipelined_lo_phase(replay, dev, tag: str) -> dict:
    """``PipelinedLidarOdometry`` over the scans of a synchronous phase of
    this call (``tag`` "LO": the voxel-hash replay tree; "OG": the default
    tree), with the launch counts set to 0 just before and read just after,
    held to that phase's synchronous run."""
    params, poses, scans, sync_out = replay
    odometry_replay.run_pipelined_replay(params, poses[:LO_WARMUP + 1], scans[:LO_WARMUP + 1], device=dev)
    torch.cuda.synchronize()
    cuda_knn.reset_launch_counts()
    out = odometry_replay.run_pipelined_replay(params, poses, scans, device=dev, max_in_flight=PIPE_MAX_IN_FLIGHT)
    torch.cuda.synchronize()
    launches = dict(cuda_knn.launch_counts)
    print_pipelined(tag, out, sync_out)
    check_pipelined(tag, out, sync_out, poses, MAX_ATE_M, PIPE_TRANS_M, PIPE_ROT)
    if min(launches["nn1"], launches["knn_k"]) <= 0:
        raise AssertionError(f"a kernel of the pipelined {tag} frame never launched: {launches}")
    lo, sync_lo = out["odometry"], sync_out["odometry"]
    if tag == "OG":
        occ, sync_occ = lo.submap.occupied_voxels(), sync_lo.submap.occupied_voxels()
        inserts = int(lo.submap.map_state.frame) - 1  # the first frame's insert is the first
        target = int(lo.submap.submap_cloud.count())
        print(f"OG pipelined: occupied voxels {occ} against {sync_occ} synchronous (bound max(3, "
              f"{PIPE_VOXEL_SHARE:.0%})); inserts on {inserts} of {len(poses) - 1} frames after the first; last target "
              f"{target} valid rows")
        if abs(occ - sync_occ) > max(3, PIPE_VOXEL_SHARE * sync_occ):
            raise AssertionError("OG pipelined: occupied voxels differ from the synchronous run's")
        if inserts < OG_MIN_INSERTS or target < OG_MIN_TARGET:
            raise AssertionError(f"OG pipelined: {inserts} inserts or {target} target rows under the OG bounds")
    else:
        n_kf, sync_kf = len(lo.get_keyframe_poses()), len(sync_lo.get_keyframe_poses())
        print(f"LO pipelined: {n_kf} keyframes ({sync_kf} synchronous), map voxels "
              f"{int(lo.submap.map_state.used.sum())}"
              f" ({int(sync_lo.submap.map_state.used.sum())} synchronous)")
    check_on_device(vars(lo.submap.map_state), dev)
    check_on_device(vars(lo.submap.submap_cloud), dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    queries = random_sampling(lo.preprocessed, N_QUERIES, gen).points.contiguous()
    pose = torch.as_tensor(out["poses"][-1], dtype=torch.float32, device=dev).contiguous()
    return {"launches": launches, "scan": lo.preprocessed, "queries": queries,
            "targets": {"last": (lo.submap.submap_cloud, pose)}}


def stash_memory(params, dev) -> None:
    """What PIPE_MAX_IN_FLIGHT stashed map states cost at the default tree's
    map capacity: their bytes, and the device memory that as many distinct
    states take."""
    sm = Submap(params, device=dev)
    st = sm.map_state
    per = sum(t.numel() * t.element_size() for t in vars(st).values())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    held = [dataclasses.replace(st, **{k: v.clone() for k, v in vars(st).items()}) for _ in range(PIPE_MAX_IN_FLIGHT)]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    print(f"stashes: one {sm.map_capacity}-slot occupancy-grid state holds {per / 2**20:.3f} MiB; "
          f"{len(held)} distinct states take {peak / 2**20:.3f} MiB of device memory at peak")


def vhm_as_set(state) -> dict:
    """voxel coordinates -> (count, summed position), on the host."""
    used = state.used.cpu().numpy()
    return dict(zip(map(tuple, state.coords.cpu().numpy()[used]),
                    zip(state.count.cpu().numpy()[used], map(tuple, state.sum_pos.cpu().numpy()[used]))))


def drop_retry_phase(dev) -> None:
    """A pipelined replay on a map too small for its inserts: the drop-retry
    reconcile must fire, end with nothing dropped, and leave the map that
    the sequential retry leaves on the same stashed clouds."""
    n_az, n_rings = SMALL_RAYS
    poses, scans = odometry_replay.make_scans(DROP_FRAMES, n_az, n_rings, device=dev)
    params = odometry_replay.replay_params(poses[0], *DROP_CAPACITIES)
    params = dataclasses.replace(params, submap=dataclasses.replace(params.submap, voxel_size=DROP_VOXEL))
    lo = PipelinedLidarOdometry(params, device=dev)
    sm, chains = lo.submap, []
    real = sm.reconcile_chain

    def reconcile_and_compare(clouds, poses_in, window, grow_first=True):
        ref = Submap(params, device=dev)
        ref.map_state, ref.map_config, ref.extract_capacity, ref.submap_cloud = (
            sm.map_state, sm.map_config, sm.extract_capacity, sm.submap_cloud)
        host = [torch.as_tensor(T).cpu().numpy().astype(np.float32) for T in poses_in]
        ref.retry_insert_after_drop(clouds[0], host[0])
        for c, T in zip(clouds[1:], host[1:]):
            if c is not None:  # a frame off a keyframe inserted nothing
                ref.retry_insert_after_drop(c, T, grow_first=False)
        real(clouds, poses_in, window, grow_first)
        chains.append((len(clouds), sm.map_capacity, ref.map_capacity, vhm_as_set(sm.map_state),
                       vhm_as_set(ref.map_state), int(sm.map_state.dropped)))

    sm.reconcile_chain = reconcile_and_compare
    odometry_replay.pipelined_rows(lo, scans, [odometry_replay.FRAME_DT * (i + 1) for i in range(len(scans))], dev)
    results = [r.value for _, r in lo.deferred_results]
    print(f"drop-retry replay ({n_az} x {n_rings}, {DROP_VOXEL} m voxels, from {DROP_CAPACITIES[0]} slots): "
          f"{len(chains)} reconciles, map {DROP_CAPACITIES[0]} -> {sm.map_capacity} slots, dropped "
          f"{int(sm.map_state.dropped)}, deepest window {lo.in_flight_peak}")
    for k, (w, cap, ref_cap, got, want, dropped) in enumerate(chains):
        same_keys = got.keys() == want.keys()
        count_gap = max((abs(float(got[v][0]) - float(want[v][0])) for v in got.keys() & want.keys()), default=0.0)
        pos_gap = max((max(abs(a - b) for a, b in zip(got[v][1], want[v][1])) for v in got.keys() & want.keys()),
                      default=0.0)
        print(f"  reconcile {k}: {w} frames re-applied, chain at {cap} slots, sequential retry at {ref_cap}; maps "
              f"{len(got)} / {len(want)} voxels, the same set {same_keys}, counts apart {count_gap}, summed "
              f"positions apart {pos_gap:.3g}, dropped {dropped}")
        if not same_keys or count_gap or pos_gap > DROP_POS_ATOL or dropped:
            raise AssertionError("the reconcile chain's map differs from the sequential retry's")
    if not chains:
        raise AssertionError("the drop-retry reconcile never fired")
    if results != ["success"] * (DROP_FRAMES - 1) or int(sm.map_state.dropped):
        raise AssertionError(f"drop-retry replay: results {results}, dropped {int(sm.map_state.dropped)}")


def pipelined_lio_phase(replay, dev) -> dict:
    """``PipelinedLidarInertialOdometry`` over the LIO phase's inputs, with
    the launch counts set to 0 just before and read just after, held to that
    phase's synchronous run."""
    params, inputs, sync_out = replay
    n = len(inputs.scans)
    lio_replay.run_pipelined_lio_replay(
        params, inputs._replace(scans=inputs.scans[:LIO_WARMUP + 1], poses=inputs.poses[:LIO_WARMUP + 1]), device=dev)
    torch.cuda.synchronize()
    cuda_knn.reset_launch_counts()
    out = lio_replay.run_pipelined_lio_replay(params, inputs, device=dev, max_in_flight=PIPE_MAX_IN_FLIGHT)
    torch.cuda.synchronize()
    launches = dict(cuda_knn.launch_counts)
    print_pipelined("LIO", out, sync_out)
    check_pipelined("LIO", out, sync_out, inputs.poses, MAX_LIO_ATE_M, PIPE_TRANS_M, None)
    odo, sync_odo = out["odometry"], sync_out["odometry"]
    n_kf, sync_kf = len(odo.get_keyframe_poses()), len(sync_odo.get_keyframe_poses())
    print(f"LIO pipelined: {n_kf} keyframes ({sync_kf} synchronous), final bias errors gyro "
          f"{out['gyro_bias_err']:.6f} rad/s, accel {out['accel_bias_err']:.6f} m/s^2 ({n} frames)")
    if n_kf != sync_kf:
        raise AssertionError("LIO pipelined: the keyframe count differs from the synchronous run's")
    if min(launches["nn1"], launches["knn_k"]) <= 0:
        raise AssertionError(f"a kernel of the pipelined LIO frame never launched: {launches}")
    check_on_device(odo.get_state()._asdict(), dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    queries = random_sampling(odo.preprocessed, N_QUERIES, gen).points.contiguous()
    pose = torch.as_tensor(out["poses"][-1], dtype=torch.float32, device=dev).contiguous()
    return {"launches": launches, "scan": odo.preprocessed, "queries": queries,
            "targets": {"last": (odo.submap.submap_cloud, pose)}}


def checkpoint_phase(replay, dev) -> None:
    """The default tree with every point taken: CKPT_FRAMES[0] frames, a
    checkpoint, then CKPT_FRAMES[1] more; the checkpoint loaded into a fresh
    LidarOdometry and a fresh PipelinedLidarOdometry, which run the same
    frames: their poses within CKPT_MAX_M of the uninterrupted run's."""
    params, poses, scans, _ = replay
    params = every_point(params)
    n0, n1 = CKPT_FRAMES
    t = [odometry_replay.FRAME_DT * (i + 1) for i in range(n0 + n1)]
    lo = LidarOdometry(params, device=dev)
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/state.npz"
        for i in range(n0):
            lo.process(scans[i], t[i])
        save_checkpoint(path, lo)
        full = []
        for i in range(n0, n0 + n1):
            lo.process(scans[i], t[i])
            full.append(lo.get_odometry())
        for cls in (LidarOdometry, PipelinedLidarOdometry):
            o = cls(params, device=dev)
            load_checkpoint(path, o)
            cuda_knn.reset_launch_counts()
            got = []
            for i in range(n0, n0 + n1):
                r = o.process(scans[i], t[i])
                got.append(o.get_odometry())
            if cls is PipelinedLidarOdometry:
                o.flush()
                got = [T for _, _, T, _ in o.pose_log]
            launches = dict(cuda_knn.launch_counts)
            gap = max(float(np.abs(a[:3, 3] - b[:3, 3]).max()) for a, b in zip(got, full, strict=True))
            print(f"checkpoint (default tree, every point, {scans[0].capacity} rays a scan): resumed {cls.__name__} "
                  f"after {n0} frames, "
                  f"{n1} frames on: at most {gap:.3g} m from the uninterrupted run (bound {CKPT_MAX_M}); "
                  f"launches {launches}")
            if not gap <= CKPT_MAX_M or min(launches["nn1"], launches["knn_k"]) <= 0 or r.value != "success":
                raise AssertionError(f"checkpoint: the resumed {cls.__name__} left the uninterrupted run")


def server_phase(replay, dev) -> None:
    """``OdometryStreamServer`` with the lo_pipelined kind, fed the LO phase's
    scans over localhost by ``OdometryStreamClient``: paced at SERVER_HZ, then
    closed loop (each scan after the pose of the one before)."""
    params, poses, scans, _ = replay
    clouds = [valid_points(s) for s in scans]
    period = 1.0 / SERVER_HZ

    def run(paced: bool):
        server = OdometryStreamServer(params, StreamServerConfig(pipeline="lo_pipelined"), device=dev)
        server.start()
        try:
            client = OdometryStreamClient("127.0.0.1", server.port, timeout=300.0)
            got, sent = {}, {}
            done = threading.Event()

            def receive():
                while True:
                    msg = client.recv()
                    if msg is None or msg.msg_type == stream_protocol.MSG_BYE:
                        break
                    if msg.msg_type == stream_protocol.MSG_POSE:
                        got[msg.seq] = (time.perf_counter(), stream_protocol.decode_pose_payload(msg.payload))
                        done.set()
            reader = threading.Thread(target=receive, daemon=True)
            reader.start()
            cuda_knn.reset_launch_counts()
            t0 = time.perf_counter()
            for i, c in enumerate(clouds):
                if paced:
                    time.sleep(max(0.0, t0 + i * period - time.perf_counter()))
                done.clear()
                sent[i + 1] = time.perf_counter()
                seq = client.send_cloud(c, odometry_replay.FRAME_DT * (i + 1))
                if not paced and i > 0 and not done.wait(60.0) and seq not in got:
                    raise AssertionError(f"server: no pose for scan {seq} within 60 s")
            stream_protocol.write_message(client.sock, stream_protocol.Message(
                msg_type=stream_protocol.MSG_BYE, seq=0, timestamp=0.0, payload=b""))
            reader.join(120.0)
            client.sock.close()
            return got, sent, server.telemetry(), dict(cuda_knn.launch_counts)
        finally:
            server.stop()

    got, sent, tele, launches = run(paced=True)
    seqs = sorted(got)
    lat = [(got[k][0] - sent[k]) * 1e3 for k in seqs]
    t_pose = [got[k][0] for k in seqs]
    rate = (len(seqs) - 1) / (t_pose[-1] - t_pose[0]) if len(seqs) > 1 else 0.0
    est = [np.asarray(poses[0])] + [pose_from(*got[k][1][3:5]) for k in seqs]
    ate = odometry_replay.ate(est, poses[:len(est)])
    print(f"server (lo_pipelined, replay tree, {scans[0].capacity} rays a scan, paced at {SERVER_HZ} Hz): "
          f"{len(seqs)} poses for {len(clouds)} scans (the first scan bootstraps), seqs {seqs[0]}..{seqs[-1]}; pose "
          f"rate {rate:.3f} a second; "
          f"pose latency (scan sent -> pose received) median {statistics.median(lat):.3f} ms, max {max(lat):.3f} ms; "
          f"scan queue dropped {tele['scan_queue_dropped']}; ATE {ate:.4f} m; launches {launches}; server queue wait "
          f"{tele['queue_wait_ms']}, process {tele['process_ms']} ms")
    if seqs != list(range(2, len(clouds) + 1)) or tele["scan_queue_dropped"]:
        raise AssertionError("server: a pose did not come back, or a scan was dropped")
    if not ate <= MAX_ATE_M:
        raise AssertionError(f"server: ATE {ate:.4f} m above {MAX_ATE_M} m")
    if min(launches["nn1"], launches["knn_k"]) <= 0:
        raise AssertionError(f"server: a kernel never launched: {launches}")
    got, sent, tele, _ = run(paced=False)
    seqs = sorted(got)
    span = got[seqs[-1]][0] - sent[2]
    closed = len(seqs) / span
    lat = [(got[k][0] - sent[k]) * 1e3 for k in seqs]
    print(f"server closed loop (each scan after the pose of the one before): {len(seqs)} poses in {span:.3f} s, "
          f"{closed:.3f} frames a second (bound {SERVER_HZ}); pose latency median {statistics.median(lat):.3f} ms, "
          f"max {max(lat):.3f} ms")
    if seqs != list(range(2, len(clouds) + 1)) or closed < SERVER_HZ:
        raise AssertionError(f"server: {SERVER_HZ} Hz not sustained: closed loop reached {closed:.3f} frames a second")


def pose_from(t, q) -> np.ndarray:
    """A [4, 4] pose from a translation and an xyzw quaternion."""
    T = np.eye(4)
    T[:3, :3] = lie.quat_to_matrix(torch.as_tensor(np.asarray(q, np.float64))).numpy()
    T[:3, 3] = t
    return T


def kitti_phase(replay, dev) -> None:
    """KITTI_FRAMES full-width scans of the default-tree phase written as
    KITTI ``.bin`` files and run through ``kitti_odometry.main --pipelined``:
    a TUM line a frame, ATE within MAX_ATE_M in the first frame's frame."""
    _, poses, scans, _ = replay
    with tempfile.TemporaryDirectory() as d:
        for i, scan in enumerate(scans[:KITTI_FRAMES]):
            c = valid_points(scan, with_intensities=True)
            raw = np.concatenate([c["points"], c["intensities"][:, None] / 255.0], axis=1).astype(np.float32)
            raw.tofile(f"{d}/{i:06d}.bin")
        cuda_knn.reset_launch_counts()
        t0 = time.perf_counter()
        rc = kitti_odometry.main([d, "--out", f"{d}/traj.tum", "--pipelined"])
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(cuda_knn.launch_counts)
        traj = np.loadtxt(f"{d}/traj.tum", ndmin=2)
    T0_inv = np.linalg.inv(poses[0])
    truth = [T0_inv @ T for T in poses[:KITTI_FRAMES]]
    est = [pose_from(r[1:4], r[4:8]) for r in traj]
    ate = odometry_replay.ate(est, truth) if len(est) == KITTI_FRAMES else float("inf")
    print(f"KITTI runner (--pipelined, {KITTI_FRAMES} full-width .bin scans): rc {rc}, {len(traj)} TUM lines, ATE "
          f"{ate:.4f} m (bound {MAX_ATE_M}), {ms:.1f} ms in all, launches {launches}")
    if rc != 0 or len(traj) != KITTI_FRAMES or not ate <= MAX_ATE_M or min(launches["nn1"], launches["knn_k"]) <= 0:
        raise AssertionError("KITTI runner: wrong trajectory")


# --- the fleet -------------------------------------------------------------------


def per_fleet_frame(rows) -> tuple[dict, dict]:
    """Host reads by ``file:line`` and batched launches, a fleet frame, over
    ``rows``."""
    reads, launches = {}, {}
    for r in rows:
        for src, k in r["reads"].items():
            reads[src] = reads.get(src, 0) + k
        for name, k in r["launches"].items():
            launches[name] = launches.get(name, 0) + k
    n = len(rows)
    return {k: v / n for k, v in reads.items()}, {k: v / n for k, v in launches.items()}


def print_fleet_timing(tag: str, frame_ms, n_streams: int, rows=None) -> float:
    """ms a fleet frame (median, max), a stream frame and stream-frames a
    second over ``frame_ms``; reads and launches a fleet frame over
    ``rows``. Returns the median."""
    med = statistics.median(frame_ms)
    print(f"{tag}: ms a fleet frame median {med:.3f}, max {max(frame_ms):.3f}, mean {statistics.mean(frame_ms):.3f} "
          f"(host clock, {len(frame_ms)} frames after the warm-up); ms a stream frame {med / n_streams:.3f}; "
          f"stream-frames a second {1e3 * n_streams / med:.1f}")
    if rows is not None:
        reads, launches = per_fleet_frame(rows)
        print(f"{tag}: host reads a fleet frame {sum(reads.values()):.2f}: "
              + ", ".join(f"{src} {k:.2f}" for src, k in sorted(reads.items(), key=lambda kv: -kv[1])))
        print(f"{tag}: batched launches a fleet frame: " + ", ".join(f"{k} {v:.2f}" for k, v in launches.items()))
    return med


def fleet_phase(dev) -> dict:
    """Phase 23: the fleet at the JAX fleet benchmark's deployment, held to
    its bounds and to the single-stream replay of stream 0."""
    t0 = time.perf_counter()
    trajs, scans = fleet_replay.make_fleet_scans(device=dev)
    B, n_frames, warm = fleet_replay.FLEET_STREAMS, fleet_replay.FLEET_FRAMES, fleet_replay.FLEET_WARMUP
    cap = pad_capacity_for(fleet_replay.FLEET_RAYS[0] * fleet_replay.FLEET_RAYS[1])
    print(f"fleet: {n_frames} x {B} scans of {cap} rays ({len(scans[0][0])} returns in stream 0's first), made in "
          f"{time.perf_counter() - t0:.2f} s")
    params = fleet_replay.fleet_params()
    torch.cuda.synchronize()
    sync.reset_sync_count()
    cuda_knn.reset_launch_counts()
    out = fleet_replay.run_fleet_replay(params, trajs, scans, device=dev, capacity=cap)
    torch.cuda.synchronize()
    launches = dict(cuda_knn.launch_counts)
    fleet = out["fleet"]
    rows = out["rows"][warm:]
    med = print_fleet_timing("fleet", [r["ms"] for r in rows], B, rows)
    print(f"fleet: flush {out['flush_ms']:.3f} ms; launches in all {launches}; processing times of the last frame "
          + ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in sorted(fleet.processing_times.items())))

    # the single-stream pipeline on stream 0's scans, its generators seeded as stream 0's
    p0 = dataclasses.replace(params, pose=PoseParams(initial=tuple(np.asarray(trajs[0][0], np.float32).ravel())))
    assert stream_seeds(0, 0) == (1234, 4321)  # the single-stream pipeline's own seeds
    single = odometry_replay.run_pipelined_replay(
        p0, trajs[0], [PointCloud.from_numpy(scans[i][0], capacity=cap, device=dev) for i in range(n_frames)],
        device=dev)
    s_ms = [r["ms"] for r in single["rows"][warm:]]
    print(f"single-stream PipelinedLidarOdometry on stream 0's scans: ms a frame median {statistics.median(s_ms):.3f}, "
          f"max {max(s_ms):.3f}; the fleet's frame is {med / statistics.median(s_ms):.2f} single frames for {B} "
          f"streams; ATE {single['ate_m']:.4f} m")
    worst_m, worst_deg = stream0_gap(out["poses"][0], single["poses"])
    print(f"fleet stream 0 against the single-stream run: at most {worst_m * 1e3:.4f} mm and {worst_deg:.5f} deg "
          f"apart (bounds {FLEET_STREAM0_M * 1e3:.0f} mm, {FLEET_STREAM0_DEG} deg)")

    print(f"fleet: keyframes a stream {fleet.keyframe_counts.tolist()} of {n_frames - 1} frames; align "
          f"iterations a stream-frame mean {statistics.mean(i for its in fleet.align_iterations for i in its):.2f}, "
          f"the fleet's loop (the slowest stream) mean "
          f"{statistics.mean(max(its) for its in zip(*fleet.align_iterations)):.2f}")

    ates = out["ates"]
    n_sf = B * (n_frames - 1)
    not_ok = len(out["not_ok"])
    dropped = int(fleet.map_state.dropped.sum())
    print(f"fleet: ATE a stream {[round(a, 4) for a in ates]}, mean {statistics.mean(ates):.4f} m, max "
          f"{max(ates):.4f} m (bounds {FLEET_MAX_MEAN_ATE_M}, {FLEET_MAX_ATE_M}); results {out['histogram']}, not a "
          f"success: {out['not_ok']}; frames with no result {out['unaccounted']}; final capacity "
          f"{fleet.map_capacity}, dropped {dropped}, budget lost {int(fleet.budget_lost.sum())}, extraction "
          f"overflow {fleet.extract_overflow.tolist()}, growth events {fleet.growth_events}")
    check_on_device(vars(fleet.map_state), dev)
    check_on_device(vars(fleet.submap_cloud), dev)
    if out["unaccounted"] or not_ok > FLEET_MAX_NOT_OK * n_sf or dropped:
        raise AssertionError("fleet: a frame with no result, too many frames not a success, or a drop")
    if not statistics.mean(ates) <= FLEET_MAX_MEAN_ATE_M or not max(ates) <= FLEET_MAX_ATE_M:
        raise AssertionError(f"fleet: ATE {ates} above the bounds")
    if worst_m > FLEET_STREAM0_M or worst_deg > FLEET_STREAM0_DEG:
        raise AssertionError("fleet: stream 0 strays from the single-stream run")
    if min(launches["nn1_batched"], launches["knn_k_batched"]) <= 0:
        raise AssertionError(f"a kernel of the fleet never launched: {launches}")

    return {**fleet_kernel_inputs(fleet, scans[-1], cap, dev), "launches": launches, "trajs": trajs, "scans": scans}


def fleet_kernel_inputs(fleet, frame, cap: int, dev, intensities=None) -> dict:
    """A fleet's kernel inputs: its targets, 1,000 queries a stream from
    ``frame`` (the last frame's scans) through its prefilter, its final
    poses."""
    B = fleet.B
    gens = [torch.Generator(device=dev).manual_seed(SEED + s) for s in range(B)]
    pre = fleet._t.pc_processor.preprocess_streams(fleet_replay.stack_frame(frame, cap, dev, intensities), gens,
                                                   need_covs=False)
    queries = random_sampling_streams(pre, N_QUERIES, gens).points.contiguous()
    poses = torch.as_tensor(np.stack([fleet.get_odometry(s) for s in range(B)]), device=dev).contiguous()
    return {"scan": pre, "target": fleet.submap_cloud, "queries": queries, "poses": poses}


def fleet_cases(points, mask) -> dict:
    """The fleet's bit-equality cases: its targets, stream 1's masked, the
    first odd number of rows, each stream's first half twice over (every
    point has an exact tie, in another slice), ragged extents (stream b's
    valid rows cut at RAGGED_EXTENTS and the capacity, spread over the
    streams) and a scattered mask (every stream's rows in one random order,
    its valid rows spread over the capacity)."""
    B, M = mask.shape
    one_masked = mask.clone()
    one_masked[1] = False
    n_odd = (M - 1) | 1
    h = M // 2
    cuts = (*RAGGED_EXTENTS, M)
    ext = torch.tensor([cuts[b * len(cuts) // B] for b in range(B)], device=mask.device)
    perm = torch.randperm(M, generator=torch.Generator(device="cpu").manual_seed(SEED)).to(mask.device)
    return {"path": (points, mask), "stream 1 all masked": (points, one_masked),
            f"first {n_odd} rows": (points[:, :n_odd].contiguous(), mask[:, :n_odd].contiguous()),
            "halves duplicated (ties)": (torch.cat([points[:, :h], points[:, :h]], 1).contiguous(),
                                         torch.cat([mask[:, :h], mask[:, :h]], 1).contiguous()),
            "ragged extents": (points, mask & (torch.arange(M, device=mask.device)[None, :] < ext[:, None])),
            "scattered mask": (points[:, perm].contiguous(), mask[:, perm].contiguous())}


def full_sweep(prep):
    """``prep`` without its extents: the kernels sweep every row of Mp, as
    they did before a prepared target carried its extents."""
    return cuda_knn.PreppedTarget(prep.xyz, prep.M)


def slice_turns(launch, counts) -> dict:
    """Marginal ms of ``launch(slices)`` at each slice count, in turns."""
    return in_turns({s: (lambda s=s: launch(s)) for s in counts}, rounds=1)


def check_fleet_kernels(f, path: str = FLEET_PATH, tag: str = "fleet") -> list:
    """Phases 24, 27 and 29: the batched nn1 and knn_k at the shapes of the
    fleet run ``f`` of ``path``."""
    dev = f["queries"].device
    B = f["queries"].shape[0]
    rows = []
    tgt, q, poses = f["target"], f["queries"], f["poses"]
    t, m = tgt.points.contiguous(), tgt.mask
    for what, (tt, mm) in fleet_cases(t, m).items():
        prep = cuda_knn.prep_targets(tt, mm)
        got = cuda_knn.nn1_prepped_batched(prep, q, poses)
        singles = [cuda_knn.nn1_prepped(cuda_knn.prep_target(tt[b], mm[b]), q[b], poses[b]) for b in range(B)]
        check_equal("nn1_batched", got, (torch.stack([s[0] for s in singles]), torch.stack([s[1] for s in singles])),
                    f"{tag}, {what}, against {B} single launches")
        check_equal("nn1_batched", got, cuda_knn.nn1_batched_plain(tt, mm, q, poses), f"{tag}, {what}, against plain")
        check_equal("nn1_batched", got, cuda_knn.nn1_prepped_batched(full_sweep(prep), q, poses),
                    f"{tag}, {what}, against the full sweep")
        print(f"nn1_batched at the {tag}'s shape, {what}: valid {[int(v) for v in mm.sum(-1)]}, extent "
              f"{prep.extent.tolist()}")
    valid = [int(v) for v in m.sum(-1)]
    prep = cuda_knn.prep_targets(t, m)
    preps = [cuda_knn.prep_target(t[b], m[b]) for b in range(B)]
    turns = in_turns({
        "ms": lambda: cuda_knn.nn1_prepped_batched(prep, q, poses),
        "full_sweep_ms": lambda: cuda_knn.nn1_prepped_batched(full_sweep(prep), q, poses),
        "single_ms": lambda: [cuda_knn.nn1_prepped(preps[b], q[b], poses[b]) for b in range(B)],
        "plain_ms": lambda: cuda_knn.nn1_batched_plain(t, m, q, poses),
    })
    qt, chosen = cuda_knn.cluster_shape(q.shape[1], cuda_knn.NN1_QUERY_TILES, n_sm(), B)
    grids = {what: {f"{tile}x{s}": ms for tile in cuda_knn.NN1_QUERY_TILES for s, ms in slice_turns(
        lambda s, tile=tile, pr=pr: cuda_knn._nn1_cluster("nn1_batched", pr, q, poses, tile, s),
        cuda_knn.CLUSTER_SLICES).items()} for what, pr in (("extent", prep), ("full sweep", full_sweep(prep)))}
    moved = transform_points(q, poses[:, None]).contiguous()
    t_inf = torch.where(m[..., None], t, torch.inf).contiguous()
    lib = marginal_ms(lambda: torch.cdist(moved, t_inf, compute_mode="donot_use_mm_for_euclid_dist").min(dim=-1), dev)
    Q, M = q.shape[1], t.shape[1]
    sb = bound(Q * sum(valid), B * (13 * M + 20 * Q))
    print(f"nn1_batched at the {tag}'s shape (B={B}, Q={Q}, M={M}, valid {valid}, extent {prep.extent.tolist()}): "
          f"equal to {B} single launches, to its plain version and to the full sweep bit for bit "
          f"({', '.join(fleet_cases(t, m))}); in turns: kernel {turns['ms']:.4f} ms ({qt} queries x {chosen} slices), "
          f"full sweep {turns['full_sweep_ms']:.4f}, {B} single launches {turns['single_ms']:.4f}, plain "
          f"{turns['plain_ms']:.4f}; cdist+min {lib:.4f}, bound {sb[0]:.4f} ({sb[1]})")
    for what, grid in grids.items():
        print(f"nn1_batched at the {tag}'s shape, {what}, ms by query tile x slices, in turns: "
              + ", ".join(f"{k} {v:.4f}" for k, v in grid.items()))
    rows.append(row("nn1_batched", KNN_SOURCE, "sycl_points_tpu/ops/pallas_knn.py:111", path, 0.0,
                    (turns["ms"], turns["plain_ms"], lib), sb, single_ms=turns["single_ms"],
                    full_sweep_ms=turns["full_sweep_ms"],
                    shapes={f"{tag} target": {"B": B, "Q": Q, "M": M, "valid": valid,
                                              "extent": prep.extent.tolist(), "query_tile": qt, "slices": chosen,
                                              "tile_x_slices_ms": grids}}))

    shapes = {}
    for label, cloud in (("scan", f["scan"]), ("target", tgt)):
        pts, mask = cloud.points.contiguous(), cloud.mask
        for what, (pp, mm) in fleet_cases(pts, mask).items():
            prep = cuda_knn.prep_targets(pp, mm)
            got = cuda_knn.knn_k_batched(prep, pp, K)
            singles = [cuda_knn.knn_k_prepped(cuda_knn.prep_target(pp[b], mm[b]), pp[b], K) for b in range(B)]
            check_equal("knn_k_batched", got, (torch.stack([s[0] for s in singles]),
                                               torch.stack([s[1] for s in singles])),
                        f"{tag} {label}, {what}, against {B} single launches")
            check_equal("knn_k_batched", got, cuda_knn.knn_k_batched(full_sweep(prep), pp, K),
                        f"{tag} {label}, {what}, against the full sweep")
            for b in range(B):
                check_equal("knn_k_batched", (got[0][b], got[1][b]), cuda_knn.knn_k_simple(pp[b], mm[b], pp[b], K),
                            f"{tag} {label}, {what}, stream {b} against knn_k_simple")
        ref = cuda_knn.knn_k_batched_plain(pts, mask, pts, K)
        got = cuda_knn.knn_k_batched(cuda_knn.prep_targets(pts, mask), pts, K)
        torch.cuda.synchronize()
        bad = cuda_knn.knn_mismatches(got[0].reshape(-1, K), got[1].reshape(-1, K), ref[0].reshape(-1, K),
                                      ref[1].reshape(-1, K), TIE_TOL)
        err = finite_max_abs_err(got[1], ref[1])
        if bad or err > D2_ATOL:
            raise AssertionError(f"knn_k_batched disagrees with its plain version at the {tag}'s {label}")
        prep = cuda_knn.prep_targets(pts, mask)
        preps = [cuda_knn.prep_target(pts[b], mask[b]) for b in range(B)]
        turns = in_turns({
            "ms": lambda: cuda_knn.knn_k_batched(prep, pts, K),
            "full_sweep_ms": lambda: cuda_knn.knn_k_batched(full_sweep(prep), pts, K),
            "single_ms": lambda: [cuda_knn.knn_k_prepped(preps[b], pts[b], K) for b in range(B)],
            "plain_ms": lambda: cuda_knn.knn_k_batched_plain(pts, mask, pts, K),
        })
        _, chosen = cuda_knn.cluster_shape(pts.shape[1], (cuda_knn.KNN_QUERY_TILE,), n_sm(), B)
        by_slices = {what: slice_turns(lambda s, pr=pr: cuda_knn._knn_k_cluster("knn_k_batched", pr, pts, K, s),
                                       cuda_knn.CLUSTER_SLICES)
                     for what, pr in (("extent", prep), ("full sweep", full_sweep(prep)))}
        t_inf = torch.where(mask[..., None], pts, torch.inf).contiguous()
        n = pts.shape[1]
        # one batched cdist over 8 x 16,384^2 pairs exceeds its launch grid on
        # the card (cudaErrorInvalidConfiguration): there the yardstick is one
        # cdist + topk a stream
        per_stream = B * n * n > FLEET_CDIST_MAX_PAIRS
        lib = marginal_ms((lambda: [torch.cdist(pts[b], t_inf[b], compute_mode="donot_use_mm_for_euclid_dist")
                                    .topk(K, largest=False) for b in range(B)]) if per_stream else
                          (lambda: torch.cdist(pts, t_inf, compute_mode="donot_use_mm_for_euclid_dist")
                           .topk(K, largest=False)), dev)
        valid = [int(v) for v in mask.sum(-1)]
        sb = bound(n * sum(valid), B * (13 * n + 12 * n + 8 * n * K))
        shapes[label] = {"B": B, "Q": n, "M": n, "valid": valid, "extent": prep.extent.tolist(), **turns,
                         "library_ms": lib, "max_abs_err": err, "bound_ms": sb[0], "bound_by": sb[1],
                         "slices": chosen, "slices_ms": by_slices,
                         "library_call": "cdist + topk a stream" if per_stream else "one batched cdist + topk"}
        print(f"knn_k_batched at the {tag}'s {label} (B={B}, k={K}, Q=M={n}, valid {valid}, extent "
              f"{prep.extent.tolist()}): equal to {B} single launches, to knn_k_simple and to the full sweep bit for "
              f"bit ({', '.join(fleet_cases(pts, mask))}), {bad} set mismatches against its plain version, max "
              f"|d2 - plain| = {err:.3g}; in turns: kernel {turns['ms']:.4f} ms ({chosen} slices), full sweep "
              f"{turns['full_sweep_ms']:.4f}, {B} single launches {turns['single_ms']:.4f}, plain "
              f"{turns['plain_ms']:.4f}; cdist+topk {f'a stream ({B} calls) ' if per_stream else ''}{lib:.4f}, "
              f"bound {sb[0]:.4f} ({sb[1]})")
        for what, ms in by_slices.items():
            print(f"knn_k_batched at the {tag}'s {label}, {what}, ms by slices, in turns: "
                  + ", ".join(f"{s} {v:.4f}" for s, v in ms.items()))
    scan = shapes["scan"]
    rows.append(row("knn_k_batched", KNN_SOURCE, "sycl_points_tpu/ops/knn.py:223", path, scan["max_abs_err"],
                    (scan["ms"], scan["plain_ms"], scan["library_ms"]), (scan["bound_ms"], scan["bound_by"]),
                    single_ms=scan["single_ms"], full_sweep_ms=scan["full_sweep_ms"], shapes=shapes))
    for r in rows:
        r["launches"] = f["launches"][r["name"]]
    return rows


def stream0_gap(fleet_poses, single_poses) -> tuple[float, float]:
    """The largest translation (m) and rotation (deg) between stream 0's
    poses and the single-stream run's, frame by frame."""
    gaps = [(float(np.abs(a[:3, 3] - b[:3, 3]).max()),
             float(np.degrees(np.linalg.norm(lie_np.se3_log(np.linalg.inv(b) @ a)[:3]))))
            for a, b in zip(fleet_poses, single_poses, strict=True)]
    return max(g[0] for g in gaps), max(g[1] for g in gaps)


def print_fleet_results(tag: str, out, n_frames: int) -> list:
    """Each stream's ATE and the results, with every frame that is not a
    success; fails on a frame with no result, more than FLEET_MAX_NOT_OK of
    the stream-frames not a success, or a drop. Returns the ATEs."""
    fleet = out["fleet"]
    B = fleet.B
    ates = out["ates"]
    dropped = int(fleet.map_state.dropped.sum())
    print(f"{tag}: ATE a stream {[round(a, 4) for a in ates]}, mean {statistics.mean(ates):.4f} m, max "
          f"{max(ates):.4f} m; results {out['histogram']}, not a success: {out['not_ok']}; frames with no result "
          f"{out['unaccounted']}; keyframes (inserts) a stream {fleet.keyframe_counts.tolist()} of {n_frames - 1} "
          f"frames; final capacity {fleet.map_capacity}, dropped {dropped}, budget lost "
          f"{int(fleet.budget_lost.sum())}, growth events {fleet.growth_events}")
    check_on_device(vars(fleet.map_state), fleet.device)
    check_on_device(vars(fleet.submap_cloud), fleet.device)
    if out["unaccounted"] or len(out["not_ok"]) > FLEET_MAX_NOT_OK * B * (n_frames - 1) or dropped:
        raise AssertionError(f"{tag}: a frame with no result, too many frames not a success, or a drop")
    return ates


def print_lio_fleet_state(tag: str, fleet) -> None:
    """The align iterations a stream-frame and a loop, and the bias and
    velocity mirrors; fails unless the mirrors are finite."""
    its = [i for per in fleet.align_iterations for i in per]
    print(f"{tag}: align iterations a stream-frame mean {statistics.mean(its):.2f}, max {max(its)}; a loop (the "
          f"slowest stream) mean {statistics.mean(fleet.align_loops):.2f}, max {max(fleet.align_loops)}; gyro bias "
          f"{np.round(fleet.gyro_bias_np, 5).tolist()}, accel bias {np.round(fleet.accel_bias_np, 4).tolist()}, "
          f"velocity {np.round(fleet.velocity_np, 3).tolist()}")
    check_on_device(fleet.x._asdict(), fleet.device)
    if not all(np.isfinite(a).all() for a in (fleet.gyro_bias_np, fleet.accel_bias_np, fleet.velocity_np)):
        raise AssertionError(f"{tag}: non-finite bias or velocity mirrors")


def fleet_lio_phase(dev, trajs, scans) -> dict:
    """Phase 26: FleetLIO at the JAX fleet benchmark's ``--lio`` deployment
    (the fleet phase's scans), held to its bounds and to the single-stream
    pipelined LIO of stream 0."""
    B, n_frames, warm = fleet_replay.FLEET_STREAMS, fleet_replay.FLEET_FRAMES, fleet_replay.FLEET_WARMUP
    cap = pad_capacity_for(fleet_replay.FLEET_RAYS[0] * fleet_replay.FLEET_RAYS[1])
    params = fleet_replay.fleet_lio_params()
    torch.cuda.synchronize()
    sync.reset_sync_count()
    cuda_knn.reset_launch_counts()
    out = fleet_replay.run_fleet_lio_replay(params, trajs, scans, device=dev, capacity=cap)
    torch.cuda.synchronize()
    launches = dict(cuda_knn.launch_counts)
    fleet = out["fleet"]
    rows = out["rows"][warm:]
    med = print_fleet_timing("fleet LIO", [r["ms"] for r in rows], B, rows)
    print(f"fleet LIO: flush {out['flush_ms']:.3f} ms; launches in all {launches}; processing times of the last "
          f"frame " + ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in sorted(fleet.processing_times.items())))
    print_lio_fleet_state("fleet LIO", fleet)
    ates = print_fleet_results("fleet LIO", out, n_frames)

    assert stream_seeds(0, 0, inertial=True) == (1234, 4321, 99)  # the single-stream pipeline's own seeds
    single = fleet_replay.run_stream_lio_replay(params, trajs, scans, 0, device=dev, capacity=cap)
    worst_m, worst_deg = stream0_gap(out["poses"][0], single["poses"])
    s_ms = single["frame_ms"][warm:]
    print(f"single-stream PipelinedLidarInertialOdometry on stream 0's scans and IMU: ms a frame median "
          f"{statistics.median(s_ms):.3f}, max {max(s_ms):.3f}; the fleet's frame is "
          f"{med / statistics.median(s_ms):.2f} single frames for {B} streams; ATE {single['ate_m']:.4f} m; "
          f"fleet stream 0 at most {worst_m * 1e3:.4f} mm and {worst_deg:.5f} deg from it (bounds "
          f"{FLEET_STREAM0_M * 1e3:.0f} mm, {FLEET_STREAM0_DEG} deg)")
    if not statistics.mean(ates) <= FLEET_LIO_MAX_MEAN_ATE_M or not max(ates) <= FLEET_LIO_MAX_ATE_M:
        raise AssertionError(f"fleet LIO: ATE {ates} above the bounds")
    if worst_m > FLEET_STREAM0_M or worst_deg > FLEET_STREAM0_DEG:
        raise AssertionError("fleet LIO: stream 0 strays from the single-stream run")
    if min(launches["nn1_batched"], launches["knn_k_batched"]) <= 0:
        raise AssertionError(f"a kernel of the fleet LIO never launched: {launches}")
    return {**fleet_kernel_inputs(fleet, scans[-1], cap, dev), "launches": launches}


def fleet_defaults_phase(dev) -> list:
    """Phase 28: FleetOdometry and FleetLIO at the tree's default scan and
    submap trees (polar grid, occupancy grid, intensity correction), B =
    FLEET_DEFAULT_STREAMS at 512 x 32, each held to the single-stream
    pipeline of stream 0; returns the kernel inputs of both runs."""
    B, n_frames, warm = FLEET_DEFAULT_STREAMS, FLEET_DEFAULT_FRAMES, FLEET_DEFAULT_WARMUP
    n_az, n_rings = SMALL_RAYS
    trajs, scans = fleet_replay.make_fleet_scans(B, n_frames, n_az, n_rings, device=dev)
    inten = fleet_replay.fleet_intensities(scans)
    cap = pad_capacity_for(n_az * n_rings)
    runs = []
    for tag, path, params in (
            ("fleet LO, default tree", FLEET_DEFAULT_PATH, fleet_replay.fleet_params(default_trees=True)),
            ("fleet LIO, default trees", FLEET_LIO_DEFAULT_PATH, fleet_replay.fleet_lio_params(default_trees=True))):
        lio = path == FLEET_LIO_DEFAULT_PATH
        run = fleet_replay.run_fleet_lio_replay if lio else fleet_replay.run_fleet_replay
        torch.cuda.synchronize()
        sync.reset_sync_count()
        cuda_knn.reset_launch_counts()
        out = run(params, trajs, scans, device=dev, capacity=cap, intensities=inten)
        torch.cuda.synchronize()
        launches = dict(cuda_knn.launch_counts)
        fleet = out["fleet"]
        print(f"{tag} ({B} streams of {n_az} x {n_rings} rays, {n_frames} frames, {type(fleet.map_state).__name__} "
              f"at {fleet.map_capacity} slots, polar grid {fleet.params.scan.downsampling.polar.enable}, intensity "
              f"correction {fleet.params.scan.intensity_correction.enable}):")
        print_fleet_timing(tag, [r["ms"] for r in out["rows"][warm:]], B, out["rows"][warm:])
        voxels = [int(fleet.map_state.used[s].sum()) for s in range(B)]
        print(f"{tag}: map voxels a stream {voxels}; launches in all {launches}")
        if lio:
            print_lio_fleet_state(tag, fleet)
        ates = print_fleet_results(tag, out, n_frames)

        # the last frame's corrected intensities
        f = fleet_kernel_inputs(fleet, scans[-1], cap, dev, inten[-1])
        ic = fleet.params.scan.intensity_correction
        pre = fleet._t.pc_processor.refine_filter(f["scan"], fleet._t.pc_processor.prepare_context(f["scan"]))
        if pre.intensities is None or not bool(pre.mask.any()):
            raise AssertionError(f"{tag}: no corrected intensities")
        vals = pre.intensities[pre.mask]
        lo, hi = float(vals.min()), float(vals.max())
        print(f"{tag}: the last frame's corrected intensities: {vals.numel()} valid, range [{lo:.4f}, {hi:.4f}] "
              f"(the correction clamps to [{ic.min_intensity}, {ic.max_intensity}])")
        if not bool(torch.isfinite(vals).all()) or lo < ic.min_intensity or hi > ic.max_intensity:
            raise AssertionError(f"{tag}: corrected intensities out of range")

        # stream 0 alone, its generators seeded as stream 0's
        if lio:
            single = fleet_replay.run_stream_lio_replay(params, trajs, scans, 0, device=dev, capacity=cap,
                                                        intensities=inten)
        else:
            p0 = dataclasses.replace(params, pose=PoseParams(initial=tuple(np.asarray(trajs[0][0], np.float32).ravel())))
            single = odometry_replay.run_pipelined_replay(
                p0, trajs[0], [PointCloud.from_numpy(scans[i][0], intensities=inten[i][0], capacity=cap, device=dev)
                               for i in range(n_frames)], device=dev)
        worst_m, worst_deg = stream0_gap(out["poses"][0], single["poses"])
        print(f"{tag}: stream 0 at most {worst_m * 1e3:.4f} mm and {worst_deg:.5f} deg from the single-stream "
              f"pipeline on its scans (ATE {single['ate_m']:.4f} m; bound {FLEET_STREAM0_M * 1e3:.0f} mm)")
        if not max(ates) <= FLEET_DEFAULT_MAX_ATE_M:
            raise AssertionError(f"{tag}: ATE {ates} above {FLEET_DEFAULT_MAX_ATE_M} m")
        if worst_m > FLEET_STREAM0_M:
            raise AssertionError(f"{tag}: stream 0 strays from the single-stream run")
        if min(launches["nn1_batched"], launches["knn_k_batched"]) <= 0:
            raise AssertionError(f"a kernel of the {tag} never launched: {launches}")
        runs.append(({**f, "launches": launches}, path, tag))
    return runs


def fleet_kitti_phase(dev) -> None:
    """Phase 25: the fleet runner at the tree's defaults over KITTI .bin
    sequences of unequal length."""
    B = fleet_replay.FLEET_STREAMS
    n_az, n_rings = fleet_replay.FLEET_RAYS
    trajs, _ = fleet_trajectories(B, FLEET_KITTI_FRAMES)
    lengths = [FLEET_KITTI_SHORT if s == B - 1 else FLEET_KITTI_FRAMES for s in range(B)]
    world = World()
    with tempfile.TemporaryDirectory() as d:
        files = []
        for s, n in enumerate(lengths):
            seq = []
            for i in range(n):
                pts = scan_at(world, trajs[s][i], n_az=n_az, n_rings=n_rings, seed=1000 * s + i, device=dev)
                path = f"{d}/s{s}_{i:06d}.bin"
                np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1).astype(np.float32).tofile(path)
                seq.append(path)
            files.append(seq)
        torch.cuda.synchronize()
        sync.reset_sync_count()
        cuda_knn.reset_launch_counts()
        t0 = time.perf_counter()
        outs = fleet_odometry.run_fleet(files, kitti_odometry.default_kitti_params(), f"{d}/fleet", device=dev)
        torch.cuda.synchronize()
        total_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(cuda_knn.launch_counts)
        reads = dict(sync.by_source)
        ates, lines = [], []
        for s, path in enumerate(outs):
            traj = np.loadtxt(path, ndmin=2)
            lines.append(len(traj))
            T0_inv = np.linalg.inv(trajs[s][0])
            truth = [T0_inv @ T for T in trajs[s][: lengths[s]]]
            est = [pose_from(r[1:4], r[4:8]) for r in traj]
            ates.append(odometry_replay.ate(est, truth) if len(est) == lengths[s] else float("inf"))
    fleet = outs.fleet
    frame_ms = outs.frame_ms[fleet_replay.FLEET_WARMUP:]
    print(f"fleet runner ({B} KITTI sequences of {lengths} .bin scans of {n_az} x {n_rings} rays, "
          f"default_kitti_params: {fleet._t.submap.map_config.__class__.__name__} at "
          f"{fleet.map_capacity} slots): {total_ms:.1f} ms in all with the file reads")
    print_fleet_timing("fleet runner", frame_ms, B)
    n = len(outs.frame_ms)
    print(f"fleet runner: host reads a fleet frame {sum(reads.values()) / n:.2f}: "
          + ", ".join(f"{src} {k / n:.2f}" for src, k in sorted(reads.items(), key=lambda kv: -kv[1])[:8])
          + f"; launches a fleet frame: nn1_batched {launches['nn1_batched'] / n:.2f}, knn_k_batched "
          f"{launches['knn_k_batched'] / n:.2f}")
    hist = {}
    for s in range(B):
        for _, rt in fleet.deferred_results[s]:
            hist[rt.value] = hist.get(rt.value, 0) + 1
    print(f"fleet runner: TUM lines a stream {lines} (a pose a real scan: {lengths}); ATE a stream "
          f"{[round(a, 4) for a in ates]} (bound {FLEET_KITTI_MAX_ATE_M} m); results {hist}; final capacity "
          f"{fleet.map_capacity}, dropped {int(fleet.map_state.dropped.sum())}, growth events {fleet.growth_events}")
    if lines != lengths or not max(ates) <= FLEET_KITTI_MAX_ATE_M:
        raise AssertionError("fleet runner: wrong trajectories")
    if min(launches["nn1_batched"], launches["knn_k_batched"]) <= 0:
        raise AssertionError(f"a kernel of the fleet runner never launched: {launches}")


# -- the registration options -----------------------------------------------------------


def with_factor(params, **changes):
    """``params`` with ``registration.factor`` changed."""
    reg = params.registration
    return dataclasses.replace(params, registration=dataclasses.replace(
        reg, factor=dataclasses.replace(reg.factor, **changes)))


def with_options(params):
    """``params`` with the rotation constraint (weight OPTIONS_ROT_WEIGHT) and
    nl_reg (the dataclass's thresholds) on."""
    return with_factor(params, rotation_constraint=RotationConstraintParams(enable=True, weight=OPTIONS_ROT_WEIGHT),
                       degenerate_reg=DegenerateRegularizationParams(type="nl_reg"))


def c2f_rows(params, poses, scans, dev) -> dict:
    """``LidarOdometry.process`` over ``scans`` (frame ``i`` at ``t = 0.1 (i +
    1)``), each frame timed by ``odometry_replay.timed_process``, with its
    iterations, those that searched the coarse target, its launches, host
    reads and registered points."""
    lo = LidarOdometry(params, device=dev)
    rows, est = [], []
    for i, scan in enumerate(scans):
        result, ms, launches = odometry_replay.timed_process(lo, scan, odometry_replay.FRAME_DT * (i + 1), dev)
        reg = lo.reg_result if result.value == "success" else None
        rows.append({"frame": i, "result": result.value, "ms": ms, "launches": launches,
                     "syncs": lo.sync_count_last_frame, "registered": int(lo.preprocessed.count()),
                     "iterations": int(reg.iterations) if reg is not None else 0,
                     "coarse": reg.coarse_iterations if reg is not None else 0})
        est.append(lo.get_odometry())
    return {"odometry": lo, "rows": rows, "poses": est, "ate_m": odometry_replay.ate(est, poses)}


def check_c2f_frames(tag: str, out, device) -> None:
    """Every frame after the first a success, the coarse target searched,
    and on the card an nn1 launch for every align iteration (a keyframe
    adds one for its sampling weights; the plain versions on the CPU count
    none)."""
    rows = out["rows"]
    bad = [r["frame"] for r in rows[1:] if r["result"] != "success"]
    if rows[0]["result"] != "first_frame" or bad:
        raise AssertionError(f"{tag}: frames {bad} did not succeed")
    if not sum(r["coarse"] for r in rows):
        raise AssertionError(f"{tag}: the coarse target was never searched")
    if device.type == "cuda" and any(r["launches"]["nn1"] < r["iterations"] for r in rows):
        raise AssertionError(f"{tag}: fewer nn1 launches than align iterations in a frame")


def c2f_replay_phase(dev) -> dict:
    """Phase 30: LidarOdometry at the full-cloud coarse-to-fine deployment
    over C2F_FRAMES full-width scans, with the counts set to 0 just before
    and read just after; then the same scans with JAX's max_iterations
    (every iteration coarse), printed beside the JAX record."""
    t0 = time.perf_counter()
    poses, scans = odometry_replay.make_scans(C2F_FRAMES, device=dev)
    params = odometry_replay.fullcloud_c2f_params(poses[0])
    factor = params.registration.factor
    cf = factor.coarse_to_fine_iters
    print(f"full-cloud C2F replay: {C2F_FRAMES} scans of {scans[0].capacity} rays ({int(scans[0].count())} returns "
          f"in the first), made in {time.perf_counter() - t0:.2f} s; {cf} coarse iterations on every "
          f"{factor.coarse_stride}th target row, at most {factor.max_iterations} in all; registration sampling off")
    c2f_rows(params, poses[:C2F_WARMUP + 1], scans[:C2F_WARMUP + 1], dev)  # warms the allocator
    torch.cuda.synchronize()
    sync.reset_sync_count()
    cuda_knn.reset_launch_counts()
    out = c2f_rows(params, poses, scans, dev)
    torch.cuda.synchronize()
    launches = dict(cuda_knn.launch_counts)
    for r in out["rows"]:
        print(f"  frame {r['frame']:2d}: {r['result']:<12s} {r['ms']:8.3f} ms, {r['iterations']:2d} iterations "
              f"({r['coarse']} coarse), nn1 on the coarse target {r['coarse']}, on the full one "
              f"{r['launches']['nn1'] - r['coarse']} ({r['iterations'] - r['coarse']} in the align), knn_k "
              f"{r['launches']['knn_k']}, host reads {r['syncs']}, {r['registered']} points registered")
    check_c2f_frames("full-cloud C2F replay", out, dev)
    ended_coarse = [r["frame"] for r in out["rows"][1:] if r["iterations"] <= r["coarse"]]
    lo = out["odometry"]
    rows = out["rows"][C2F_WARMUP:]
    after = out["rows"][1:]
    ms = [r["ms"] for r in rows]
    n = len(after)
    voxels = int(lo.submap.map_state.used.sum())
    print(f"full-cloud C2F frame after {C2F_WARMUP} warm-up frames: median {statistics.median(ms):.3f} ms, max "
          f"{max(ms):.3f} ms; host reads a frame median {median_of(rows, lambda r: r['syncs'])}, mean "
          f"{statistics.mean(r['syncs'] for r in rows):.2f}; points registered a frame median "
          f"{median_of(rows, lambda r: r['registered'])}")
    print(f"full-cloud C2F: over the {n} frames after the first, nn1 a frame on the coarse target "
          f"{sum(r['coarse'] for r in after) / n:.2f}, on the full one "
          f"{sum(r['launches']['nn1'] - r['coarse'] for r in after) / n:.2f} (in the align "
          f"{sum(r['iterations'] - r['coarse'] for r in after) / n:.2f}, the rest a keyframe's sampling weights), knn_k "
          f"{sum(r['launches']['knn_k'] for r in after) / n:.2f}; iterations a frame "
          f"{sum(r['iterations'] for r in after) / n:.2f}; launches in all {launches}")
    print(f"full-cloud C2F: ATE {out['ate_m']:.4f} m over {len(out['rows'])} frames (bound {MAX_C2F_ATE_M} m), "
          f"frames ok {n - sum(r['result'] != 'success' for r in after) + 1}/{len(out['rows'])}, final map "
          f"{voxels} voxels; the JAX record (benchmarks/REPLAY_FULLCLOUD_C2F_r4.json, for accuracy only): ATE "
          f"{JAX_C2F_ATE_M} m, frames ok 30/30, {JAX_C2F_VOXELS} voxels")
    if ended_coarse:
        raise AssertionError(f"full-cloud C2F: frames {ended_coarse} ended their align on the coarse target")
    if not out["ate_m"] <= MAX_C2F_ATE_M:
        raise AssertionError(f"full-cloud C2F: ATE {out['ate_m']:.4f} m above {MAX_C2F_ATE_M} m")
    if min(launches["nn1"], launches["knn_k"]) <= 0:
        raise AssertionError(f"a kernel of the full-cloud C2F frame never launched: {launches}")
    check_on_device(vars(lo.submap.submap_cloud), dev)

    # the JAX benchmark's own max_iterations: every iteration coarse
    jax_like = c2f_rows(with_factor(params, max_iterations=cf), poses, scans, dev)
    check_c2f_frames("full-cloud C2F at JAX's max_iterations", jax_like, dev)
    ja = jax_like["rows"][1:]
    print(f"full-cloud C2F with JAX's max_iterations={cf} (every iteration on the coarse target, as the JAX record "
          f"ran): ATE {jax_like['ate_m']:.4f} m against the JAX record's {JAX_C2F_ATE_M} m; iterations a frame "
          f"{statistics.mean(r['iterations'] for r in ja):.2f}, all coarse: "
          f"{all(r['iterations'] == r['coarse'] for r in ja)}; final map "
          f"{int(jax_like['odometry'].submap.map_state.used.sum())} voxels")

    # the same deployment without the coarse phase: what it costs or saves
    full_only = c2f_rows(with_factor(params, coarse_to_fine_iters=0, max_iterations=factor.max_iterations - cf),
                         poses, scans, dev)
    fo = full_only["rows"][C2F_WARMUP:]
    if any(r["result"] != "success" for r in full_only["rows"][1:]):
        raise AssertionError("full-cloud deployment without the coarse phase: a frame did not succeed")
    print(f"full-cloud deployment without the coarse phase (max_iterations {factor.max_iterations - cf}): median "
          f"{statistics.median(r['ms'] for r in fo):.3f} ms a frame against {statistics.median(ms):.3f} with it; "
          f"iterations a frame {statistics.mean(r['iterations'] for r in fo):.2f}, host reads a frame "
          f"{statistics.mean(r['syncs'] for r in fo):.2f}; ATE {full_only['ate_m']:.4f} m against "
          f"{out['ate_m']:.4f} m")

    # the kernels at this path's shapes: every query row against the
    # strided coarse copy of the target (the align's own) and the full one
    # (last, so that knn_k's check takes the full target), and the coarse
    # copy of an odd target count, whose tail tile is partial
    pose = torch.as_tensor(out["poses"][-1], dtype=torch.float32, device=dev).contiguous()
    target = lo.submap.submap_cloud
    s = factor.coarse_stride
    coarse = PointCloud(points=target.points[::s].contiguous(), mask=target.mask[::s].contiguous())
    queries = lo.preprocessed.points.contiguous()
    n_odd = 10001
    odd_t, odd_m = target.points[:n_odd][::s].contiguous(), target.mask[:n_odd][::s].contiguous()
    check_equal("nn1", cuda_knn.nn1_prepped(cuda_knn.prep_target(odd_t, odd_m), queries, pose),
                cuda_knn.nn1_plain(odd_t, odd_m, queries, pose), f"C2F, coarse copy of {n_odd} rows")
    print(f"nn1 on the coarse copy of the target's first {n_odd} rows ({odd_t.shape[0]} rows, a partial tail "
          f"tile): equal to nn1_plain bit for bit")
    return {"launches": launches, "scan": lo.preprocessed, "queries": queries,
            "targets": {"coarse": (coarse, pose), "full": (target, pose)}}


def c2f_card_vs_cpu(dev) -> None:
    """Phase 32: the first C2F_CPU_FRAMES frames of the full-cloud C2F
    deployment at 512 x 32 on the card and on the CPU, every sampler taking
    every point, on the card-vs-CPU map and target sizes."""
    n_az, n_rings = SMALL_RAYS
    finals = {}
    for device in (torch.device("cpu"), dev):
        p, s = odometry_replay.make_scans(C2F_CPU_FRAMES, n_az, n_rings, device=device)
        o = c2f_rows(cpu_sized(every_point(odometry_replay.fullcloud_c2f_params(p[0]))), p, s, device)
        check_c2f_frames(f"full-cloud C2F on {device.type}", o, device)
        if any(r["iterations"] <= r["coarse"] for r in o["rows"][1:]):
            raise AssertionError(f"full-cloud C2F on {device.type}: an align ended on the coarse target")
        finals[device.type] = o["poses"][-1]
    trans, rot = pose_error(finals["cuda"], finals["cpu"])
    print(f"full-cloud C2F card vs CPU after {C2F_CPU_FRAMES} frames ({n_az} x {n_rings}, every point): "
          f"{trans * 1e3:.4f} mm, {rot:.5f} deg apart (bounds {LIO_CPU_TRANS_M * 1e3:.0f} mm, {LIO_CPU_ROT_DEG} deg)")
    if not (trans <= LIO_CPU_TRANS_M and rot <= LIO_CPU_ROT_DEG):
        raise AssertionError("the card and the CPU disagree on the full-cloud C2F replay")


def options_lo_phase(replay, dev) -> None:
    """Phase 33: the LO replay deployment with the rotation constraint and
    nl_reg over phase 7's scans, beside phase 7's run."""
    params, poses, scans, plain = replay
    params = with_options(params)
    torch.cuda.synchronize()
    cuda_knn.reset_launch_counts()
    out = odometry_replay.run_replay(params, poses, scans, device=dev)
    torch.cuda.synchronize()
    launches = dict(cuda_knn.launch_counts)
    rows = out["rows"][LO_WARMUP:]
    print(f"LO replay with the rotation constraint (weight {OPTIONS_ROT_WEIGHT}) and nl_reg: median "
          f"{statistics.median(r['ms'] for r in rows):.3f} ms a frame (phase 7: "
          f"{statistics.median(r['ms'] for r in plain['rows'][LO_WARMUP:]):.3f}), iterations a frame median "
          f"{median_of(rows, lambda r: r['iterations'])}, host syncs a frame median "
          f"{median_of(rows, lambda r: r['syncs'])}; ATE {out['ate_m']:.4f} m (phase 7: {plain['ate_m']:.4f}); "
          f"launches {launches}")
    check_replay("LO replay with the options", out, 2, MAX_ATE_M)
    if min(launches["nn1"], launches["knn_k"]) <= 0:
        raise AssertionError(f"a kernel of the LO frame with the options never launched: {launches}")


def options_lio_phase(replay, dev) -> None:
    """Phase 34: the LIO replay deployment with the rotation constraint and
    nl_reg over phase 10's inputs, beside phase 10's run."""
    params, inputs, plain = replay
    params = with_options(params)
    torch.cuda.synchronize()
    cuda_knn.reset_launch_counts()
    out = lio_replay.run_lio_replay(params, inputs, device=dev)
    torch.cuda.synchronize()
    launches = dict(cuda_knn.launch_counts)
    rows = out["rows"][LIO_WARMUP:]
    print(f"LIO replay with the rotation constraint and nl_reg: median {statistics.median(r['ms'] for r in rows):.3f} "
          f"ms a frame (phase 10: {statistics.median(r['ms'] for r in plain['rows'][LIO_WARMUP:]):.3f}), iterations "
          f"a frame median {median_of(rows, lambda r: r['iterations'])}; ATE {out['ate_m']:.4f} m (phase 10: "
          f"{plain['ate_m']:.4f}); launches {launches}")
    check_lio("LIO replay with the options", out, MAX_LIO_ATE_M)
    if min(launches["nn1"], launches["knn_k"]) <= 0:
        raise AssertionError(f"a kernel of the LIO frame with the options never launched: {launches}")


def options_fleet_lio_phase(dev, trajs, scans) -> None:
    """Phase 35: FleetLIO at the benchmark's --lio deployment with the
    rotation constraint and nl_reg, over the first OPTIONS_FLEET_FRAMES
    frames of phase 23's scans, held to the single-stream run of stream 0."""
    n = OPTIONS_FLEET_FRAMES
    trajs, scans = [t[:n] for t in trajs], scans[:n]
    cap = pad_capacity_for(fleet_replay.FLEET_RAYS[0] * fleet_replay.FLEET_RAYS[1])
    params = with_options(fleet_replay.fleet_lio_params())
    torch.cuda.synchronize()
    sync.reset_sync_count()
    cuda_knn.reset_launch_counts()
    out = fleet_replay.run_fleet_lio_replay(params, trajs, scans, device=dev, capacity=cap)
    torch.cuda.synchronize()
    launches = dict(cuda_knn.launch_counts)
    tag = "fleet LIO with the options"
    print_fleet_timing(tag, [r["ms"] for r in out["rows"][fleet_replay.FLEET_WARMUP:]], len(trajs),
                       out["rows"][fleet_replay.FLEET_WARMUP:])
    print_lio_fleet_state(tag, out["fleet"])
    ates = print_fleet_results(tag, out, n)
    single = fleet_replay.run_stream_lio_replay(params, trajs, scans, 0, device=dev, capacity=cap)
    worst_m, worst_deg = stream0_gap(out["poses"][0], single["poses"])
    print(f"{tag}: stream 0 at most {worst_m * 1e3:.4f} mm and {worst_deg:.5f} deg from the single-stream run "
          f"(bounds {FLEET_STREAM0_M * 1e3:.0f} mm, {FLEET_STREAM0_DEG} deg); launches {launches}")
    if not statistics.mean(ates) <= FLEET_LIO_MAX_MEAN_ATE_M or not max(ates) <= FLEET_LIO_MAX_ATE_M:
        raise AssertionError(f"{tag}: ATE {ates} above the bounds")
    if worst_m > FLEET_STREAM0_M or worst_deg > FLEET_STREAM0_DEG:
        raise AssertionError(f"{tag}: stream 0 strays from the single-stream run")
    if min(launches["nn1_batched"], launches["knn_k_batched"]) <= 0:
        raise AssertionError(f"a batched kernel of the {tag} never launched: {launches}")


def intensity_sampling_phase(replay, dev) -> None:
    """Phase 31: LidarOdometry at the tree's defaults with intensity-weighted
    registration sampling over phase 13's scans; the last frame's draw,
    made again as the frame made it, must hold round(num x weighted_ratio)
    weighted points."""
    params, poses, scans, plain = replay
    sp = dataclasses.replace(params.registration_sampling, use_intensities=True)
    params = dataclasses.replace(params, registration_sampling=sp)
    torch.cuda.synchronize()
    cuda_knn.reset_launch_counts()
    out = odometry_replay.run_replay(params, poses, scans, device=dev)
    torch.cuda.synchronize()
    launches = dict(cuda_knn.launch_counts)
    lo = out["odometry"]
    rows = out["rows"][LO_WARMUP:]
    # the occupancy grid inserts every frame and lists no keyframe past the first
    check_replay("default tree with intensity-weighted sampling", out, 1, MAX_ATE_M)
    pre = lo.preprocessed
    if pre.intensities is None:
        raise AssertionError("intensity-weighted sampling: the scans carry no intensities")
    drawn = align_pipeline(pre, lo.submap.submap_cloud, lo.submap.submap_knn, lo.pipeline_params,
                           initial_guess=torch.as_tensor(out["poses"][-1], dtype=torch.float32, device=dev))
    n_w = round(sp.num * sp.weighted_ratio)
    took = int(drawn.registration_input.mask[:n_w].sum())
    positive = bool((drawn.registration_input.intensities[:n_w][drawn.registration_input.mask[:n_w]] > 0).all())
    print(f"default tree with intensity-weighted sampling (num {sp.num}, weighted_ratio {sp.weighted_ratio}): median "
          f"{statistics.median(r['ms'] for r in rows):.3f} ms a frame (phase 13: "
          f"{statistics.median(r['ms'] for r in plain['rows'][LO_WARMUP:]):.3f}), ATE {out['ate_m']:.4f} m (phase "
          f"13: {plain['ate_m']:.4f}); the last frame's draw took {took} weighted points of {n_w} (all of positive "
          f"intensity: {positive}), {int(drawn.registration_input.count())} in all; launches {launches}")
    if took < n_w or not positive:
        raise AssertionError(f"intensity-weighted sampling took {took} weighted points, fewer than {n_w}")
    if min(launches["nn1"], launches["knn_k"]) <= 0:
        raise AssertionError(f"a kernel of the intensity-sampled frame never launched: {launches}")


# --------------------------------------------------------------------------
# the raw range-image path (phases 37-41)
# --------------------------------------------------------------------------


def with_raw(params, **kw):
    """``params`` with the raw-features covariances (range-image
    neighbourhoods of the raw scan, carried through the downsampling)."""
    return dataclasses.replace(params, covariance_estimation=dataclasses.replace(
        params.covariance_estimation, raw_range_image=True, **kw))


def window_pairs(img_i: torch.Tensor, n_az: int, n_rings: int, w_az: int, w_el: int) -> int:
    """The (cell, window cell) pairs the window search computes a distance
    for: both occupied, the window cell on the image."""
    occ = (img_i >= 0).reshape(n_az, n_rings)
    pairs = 0
    for da, de in range_image_knn.window_offsets(w_az, w_el):
        lo, hi = max(0, -de), min(n_rings, n_rings - de)
        nb = torch.roll(occ, -da, 0)[:, lo + de:hi + de]
        pairs += int((occ[:, lo:hi] & nb).sum())
    return pairs


def range_image_cases(points: torch.Tensor, mask: torch.Tensor) -> dict:
    """The bit-equality cases of the range image: the path's full-width
    scan; the scan with every 3rd return doubled 3 mm off (collisions);
    every point masked; a quarter of the azimuths and the lower half of the
    fan with the full scan's elevation bounds given."""
    el = torch.asin(points[:, 2] / torch.linalg.vector_norm(points, dim=1).clamp_min(1e-9))
    el_min, el_max = float(el[mask].min()), float(el[mask].max())
    az = torch.atan2(points[:, 1], points[:, 0])
    dup = torch.cat([points, points[::3] + 0.003]).contiguous()
    return {
        "full width": (points, mask, {}),
        "collisions": (dup, torch.cat([mask, mask[::3]]), {}),
        "all masked": (points, torch.zeros_like(mask), {}),
        "partial fan, el_min/el_max given": (points, mask & (az.abs() < np.pi / 4) & (el < 0.5 * (el_min + el_max)),
                                             {"el_min": el_min, "el_max": el_max}),
    }


def device_launches(fn) -> int:
    """Kernels and memsets the card ran for ``fn()``, under the profiler."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def first_sequence(points, mask, k, n_az, n_rings, w_az, w_el):
    """``range_image_knn`` as the port first ran it on the card: the plain
    steps 1-2 and 4 around the first window design."""
    img_p, img_i, cell, ok, collisions = range_image_knn.range_image(points, mask, n_az, n_rings)
    return range_image_knn.point_rows(*range_image_knn.range_image_window_simple(img_p, img_i, n_az, n_rings, w_az,
                                                                                 w_el, k), cell, ok), collisions


def check_range_image(scan, std_scan, launches: dict) -> list:
    """The range-image kernels against their plain versions, bit for bit, in
    every case of :func:`range_image_cases`: the window search (the tiled
    kernel and the first design) on the image and after the
    self-substitution; the card's ``range_image_knn`` against the plain
    sequence (cells, winners, occupancy, rows, collisions) and its device
    launches. Then times in turns (the window kernel, its first design and
    plain version; the card path, the first sequence and the ``knn_k``
    self-search of the standard frame's post-voxel scan it replaces; the
    elevation, cells and rows kernels beside their plain steps) and the
    bounds. ``launches``: the raw frames' counts."""
    ce = CovarianceEstimationParams()
    n_az, n_rings, w_az, w_el, k = (ce.range_image_n_az, ce.range_image_n_rings, ce.range_image_window_az,
                                    ce.range_image_window_el, ce.neighbor_num)
    ri = range_image_knn
    pts, mask = scan.points.contiguous(), scan.mask.contiguous()
    ta = ri.range_image_tile(n_rings, w_az)
    fused_launches = {}
    for what, (p, m, kw) in range_image_cases(pts, mask).items():
        img_p, img_i, cell, ok, coll = ri.range_image(p, m, n_az, n_rings, **kw)
        got = ri.range_image_window(img_p, img_i, n_az, n_rings, w_az, w_el, k)
        simple = ri.range_image_window_simple(img_p, img_i, n_az, n_rings, w_az, w_el, k)
        ref = ri.range_image_window_plain(img_p, img_i, n_az, n_rings, w_az, w_el, k)
        torch.cuda.synchronize()
        check_equal("range_image", got, ref, f"{what}, the image")
        check_equal("range_image_simple", simple, ref, f"{what}, the image")
        res, plain = ri.point_rows(*got, cell, ok), ri.point_rows(*ref, cell, ok)
        check_equal("range_image", (res.indices, res.distances), (plain.indices, plain.distances),
                    f"{what}, after the self-substitution")
        cells, ref_cells = ri.range_image_cells(p, m, n_az, n_rings, **kw), ri.range_image_cells_plain(
            p, m, n_az, n_rings, **kw)
        for name, a, b in zip(("cells", "winners", "occupancy", "collisions"), cells, ref_cells):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"range_image_cells ({what}): the {name} differ from the plain steps")
        fused = ri.range_image_knn(p, m, k, n_az, n_rings, w_az, w_el, **kw)
        check_equal("range_image_knn", (fused.knn.indices, fused.knn.distances), (plain.indices, plain.distances),
                    f"{what}, the card's path against the plain sequence")
        if int(fused.collisions) != int(coll):
            raise AssertionError(f"range_image_knn ({what}): {int(fused.collisions)} collisions, plain {int(coll)}")
        fused_launches[what] = device_launches(lambda: ri.range_image_knn(p, m, k, n_az, n_rings, w_az, w_el, **kw))
        print(f"range_image ({what}: {p.shape[0]} points, {int(m.sum())} valid, {int((img_i >= 0).sum())} cells "
              f"occupied, {int(coll)} collisions): the tiled window kernel ({ta} columns a block) and the first "
              f"design equal to the plain window bit for bit, the image and the points; the card's range_image_knn "
              f"equal to the plain sequence in every cell, winner, occupancy, row and collisions, "
              f"{fused_launches[what]} device launches (kernels and memsets)")
        if what == "collisions" and int(coll) == 0:
            raise AssertionError("the collision case made no collision")
        if what == "all masked" and not (bool(torch.isinf(res.distances).all()) and bool((img_i < 0).all())):
            raise AssertionError("range_image with every point masked must leave the image empty")
        if fused_launches[what] > MAX_RANGE_IMAGE_LAUNCHES:
            raise AssertionError(f"range_image_knn ({what}) ran {fused_launches[what]} device launches")
    seq_launches = device_launches(lambda: first_sequence(pts, mask, k, n_az, n_rings, w_az, w_el))

    img_p, img_i, cell, ok, _ = ri.range_image(pts, mask, n_az, n_rings)
    sp, sm = std_scan.points.contiguous(), std_scan.mask
    turns = in_turns({
        "plain_ms": lambda: ri.range_image_window_plain(img_p, img_i, n_az, n_rings, w_az, w_el, k),
        "ms": lambda: ri.range_image_window(img_p, img_i, n_az, n_rings, w_az, w_el, k),
        "previous_ms": lambda: ri.range_image_window_simple(img_p, img_i, n_az, n_rings, w_az, w_el, k),
        "range_image_knn_ms": lambda: ri.range_image_knn(pts, mask, k),
        "first_sequence_ms": lambda: first_sequence(pts, mask, k, n_az, n_rings, w_az, w_el),
        "replaced_knn_k_ms": lambda: self_knn(sp, sm, k),
    })
    # the per-point kernels alone, beside their plain steps
    N, C = pts.shape[0], n_az * n_rings
    ok_p, _, el = ri.point_angles(pts, mask)
    lo, hi = (float(x) for x in ri.elevation_bounds(ok_p, el))
    scratch = torch.zeros(2 * C + 3, dtype=torch.int32, device=pts.device)
    cell32 = torch.empty(N, dtype=torch.int32, device=pts.device)
    idx_c, d_c = ri.range_image_window(img_p, img_i, n_az, n_rings, w_az, w_el, k)

    def cells_kernel():
        scratch.zero_()
        ri._cells_launch(pts, mask, n_az, n_rings, lo, hi, scratch, cell32)

    steps = in_turns({
        "elevation_plain_ms": lambda: ri.elevation_bounds(*ri.point_angles(pts, mask)[::2]),
        "elevation_ms": lambda: ri._elevation_launch(pts, mask, scratch),
        "cells_plain_ms": lambda: ri.range_image_cells_plain(pts, mask, n_az, n_rings, lo, hi),
        "cells_ms": cells_kernel,
        "rows_plain_ms": lambda: ri.point_rows(idx_c, d_c, cell, ok),
        "rows_ms": lambda: ri.cell_rows(idx_c, d_c, cell.to(torch.int32)),
    })
    occupied = int((img_i >= 0).sum())
    pairs = window_pairs(img_i, n_az, n_rings, w_az, w_el)
    sb = bound(pairs, C * 16 + C * k * 8)
    angle_pairs = -(-N * RAW_ANGLE_OPS // OPS_PER_PAIR)
    bounds = {"elevation": bound(angle_pairs, 13 * N + 8),
              "cells": bound(angle_pairs, 13 * N + 4 * N + 8 * C + 4),
              "rows": bound(0, 4 * N + 8 * k * occupied + 8 * k * N)}
    print(f"range_image at the raw frame's shape ({n_az} x {n_rings} cells, {occupied} occupied, {pairs} window "
          f"pairs, k={k}, TA {ta}), marginal CUDA-event ms per launch, medians in turns: "
          + ", ".join(f"{name} {v:.4f}" for name, v in turns.items())
          + f" (knn_k with prep over the standard frame's scan, {sp.shape[0]} rows, {int(sm.sum())} valid); window "
          f"bound {sb[0]:.4f} ({sb[1]}); the card's range_image_knn {fused_launches['full width']} device launches, "
          f"the first sequence {seq_launches}; tiled / first design {turns['ms'] / turns['previous_ms']:.3f}, card "
          f"path / first sequence {turns['range_image_knn_ms'] / turns['first_sequence_ms']:.3f}; no library call "
          f"computes this search")
    print("range_image's per-point kernels, medians in turns: " + ", ".join(f"{n} {v:.4f}" for n, v in steps.items())
          + "; bounds " + ", ".join(f"{n} {b[0]:.6f} ({b[1]})" for n, b in bounds.items())
          + " (cells_ms with its memset)")
    shapes = {"raw scan": {"cells": C, "occupied": occupied, "pairs": pairs, "k": k, "tile_az": ta,
                           "fused_launches": fused_launches, "first_sequence_launches": seq_launches}}
    common = dict(range_image_knn_ms=turns["range_image_knn_ms"], first_sequence_ms=turns["first_sequence_ms"],
                  replaced_knn_k_ms=turns["replaced_knn_k_ms"])
    return [
        row("range_image", RAW_SOURCE, RAW_REPLACES, RAW_PATH, 0.0, (turns["ms"], turns["plain_ms"], None), sb,
            launches=launches["range_image"], previous_ms=turns["previous_ms"], shapes=shapes, **common),
        row("range_image_simple", RAW_SOURCE, RAW_REPLACES, RAW_PATH, 0.0,
            (turns["previous_ms"], turns["plain_ms"], None), sb, launches=launches["range_image_simple"]),
        row("range_image_elevation", RAW_SOURCE, RAW_ELEVATION_REPLACES, RAW_PATH, 0.0,
            (steps["elevation_ms"], steps["elevation_plain_ms"], None), bounds["elevation"],
            launches=launches["range_image_elevation"]),
        row("range_image_cells", RAW_SOURCE, RAW_CELLS_REPLACES, RAW_PATH, 0.0,
            (steps["cells_ms"], steps["cells_plain_ms"], None), bounds["cells"],
            launches=launches["range_image_cells"]),
        row("range_image_rows", RAW_SOURCE, RAW_ROWS_REPLACES, RAW_PATH, 0.0,
            (steps["rows_ms"], steps["rows_plain_ms"], None), bounds["rows"], launches=launches["range_image_rows"]),
    ]


def raw_collisions(params, scans) -> list:
    """The range image's collision count of each scan after the box filter,
    as the raw-features prefilter makes it."""
    box = params.scan.preprocess.box_filter
    out = []
    for s in scans:
        c = box_filter(s, box.min, box.max)
        out.append(int(range_image_knn.range_image(c.points, c.mask)[4]))
    return out


def raw_vs_standard(tag: str, run, params, inputs) -> dict:
    """The standard frame and the raw-features frame of ``params`` over the
    same inputs in one call, at the package's seeds, in turns (standard,
    raw, each again with synchronised stages); the raw run with the counts
    set to 0 just before and read just after. Prints ms a frame (median,
    max), the preprocess stage, nn1 / knn_k / range_image launches a frame
    and the ATE of each; fails unless every frame after the first succeeds
    and range_image and nn1 launched."""
    raw_params = with_raw(params)
    std = run(params, inputs)
    torch.cuda.synchronize()
    cuda_knn.reset_launch_counts()
    raw = run(raw_params, inputs)
    torch.cuda.synchronize()
    launches = dict(cuda_knn.launch_counts)
    runs = {"standard": (std, run(params, inputs, sync_stage_times=True)),
            "raw": (raw, run(raw_params, inputs, sync_stage_times=True))}
    out = {}
    for name, (o, st) in runs.items():
        rows = o["rows"][LO_WARMUP:]
        bad = [r["frame"] for r in o["rows"][1:] if r["result"] != "success"]
        pre = median_of(st["rows"][LO_WARMUP:], lambda r: r["stages_ms"].get("1. preprocessing", 0.0))
        per = {k: sum(r["launches"][k] for r in o["rows"][1:]) / (len(o["rows"]) - 1) for k in FRAME_KERNELS}
        print(f"{tag}, {name} frame: median {statistics.median(r['ms'] for r in rows):.3f} ms, max "
              f"{max(r['ms'] for r in rows):.3f} ms (frames {LO_WARMUP}-{len(o['rows']) - 1}); preprocess stage "
              f"{pre:.3f} ms (synchronised stages); launches a frame after the first: "
              + ", ".join(f"{k} {v:.2f}" for k, v in per.items())
              + f"; ATE {o['ate_m']:.4f} m at the package's seeds; frames not a success {bad}")
        if bad:
            raise AssertionError(f"{tag}, {name}: frames {bad} did not succeed")
        out[name] = {"ms": statistics.median(r["ms"] for r in rows), "max_ms": max(r["ms"] for r in rows),
                     "preprocess_ms": pre, "launches": per, "ate_m": o["ate_m"]}
    print(f"{tag}: raw-run launches {launches}")
    if min(launches[name] for name in RAW_KERNELS + ("nn1",)) <= 0:
        raise AssertionError(f"{tag}: a kernel of the raw frame never launched: {launches}")
    out["kernel_launches"] = launches
    out["raw_run"] = raw
    return out


def raw_spread(tag: str, run, params, inputs, bound: float, margin: float | None) -> dict:
    """The ATE of the standard and the raw-features frames of ``params`` under
    each of RAW_SEEDS (the scan's and the submap's samplers reseeded); fails
    unless every frame after the first succeeds, the raw frames' median ATE
    is within ``bound`` and (where ``margin`` is given) within ``margin`` of
    the standard frames' median."""
    ates = {}
    for name, p in (("standard", params), ("raw", with_raw(params))):
        ates[name] = []
        for seed in RAW_SEEDS:
            o = run(p, inputs, seed=seed)
            bad = [r["frame"] for r in o["rows"][1:] if r["result"] != "success"]
            if bad:
                raise AssertionError(f"{tag}, {name}, seed {seed}: frames {bad} did not succeed")
            ates[name].append(o["ate_m"])
    med = {name: statistics.median(v) for name, v in ates.items()}
    print(f"{tag}: ATE over {len(RAW_SEEDS)} sampling seeds (the package's first): "
          + "; ".join(f"{name} median {med[name]:.4f} m, max {max(v):.4f} m, all {[round(a, 4) for a in v]}"
                      for name, v in ates.items())
          + f"; raw median - standard median {(med['raw'] - med['standard']) * 100:.3f} cm (bound {bound} m, "
          f"margin {margin} m)")
    if not med["raw"] <= bound or (margin is not None and abs(med["raw"] - med["standard"]) > margin):
        raise AssertionError(f"{tag}: the raw frames' median ATE {med['raw']:.4f} m is out of bounds")
    return {"ates": ates, "median": med}


def plain_estimator(params):
    """``params`` with the plain covariance estimator, as the JAX
    raw-features test runs both paths."""
    ce = params.covariance_estimation
    return dataclasses.replace(params, covariance_estimation=dataclasses.replace(
        ce, m_estimation=dataclasses.replace(ce.m_estimation, enable=False)))


def raw_frames_phase(lo_replay_out, og_replay_out, lio_replay_out, dev) -> dict:
    """Phases 37 and 39: the raw-features LO frame at the replay deployment
    and at the default tree, and the raw-features LIO frame, each beside
    the standard frame on the same inputs: timed at the package's seeds,
    then the ATE over RAW_SEEDS with the deployed (robust) estimator and
    with the JAX raw-features test's plain one."""
    params, poses, scans, _ = lo_replay_out
    og_params, og_poses, og_scans, _ = og_replay_out
    lio_params_, lio_inputs, _ = lio_replay_out

    def run_lo(p, s, sync_stage_times=False, seed=None):
        return odometry_replay.run_replay(p, s[0], s[1], device=dev, sync_stage_times=sync_stage_times, seed=seed)

    def run_lio(p, inp, sync_stage_times=False, seed=None):
        return lio_replay.run_lio_replay(p, inp, device=dev, sync_stage_times=sync_stage_times, seed=seed)

    coll = raw_collisions(params, scans)
    print(f"raw LO: range-image collisions a scan after the box filter: median {statistics.median(coll)}, max "
          f"{max(coll)} (of {scans[0].capacity} rays)")
    out = {"collisions": coll}
    for name, run, p, inputs in (("replay deployment", run_lo, params, (poses, scans)),
                                 ("default tree", run_lo, og_params, (og_poses, og_scans)),
                                 ("LIO replay deployment", run_lio, lio_params_, lio_inputs)):
        tag = f"raw {'LIO' if run is run_lio else 'LO'} ({name}, 2048 x 64)"
        print(f"{tag}: the JAX package's ATE on these scans on the CPU at its seeds (raw / standard, for accuracy "
              f"only): " + ", ".join(f"{est} estimator {r} / {st} m" for est, (r, st) in JAX_RAW_ATE_M[name].items()))
        out[name] = raw_vs_standard(tag, run, p, inputs)
        robust_bound, plain_bound, plain_margin = RAW_BOUNDS[name]
        out[name]["robust spread"] = raw_spread(f"{tag}, robust estimator", run, p, inputs, robust_bound, None)
        out[name]["plain spread"] = raw_spread(f"{tag}, plain estimator", run, plain_estimator(p), inputs,
                                               plain_bound, plain_margin)
    out["kernel_launches"] = out["replay deployment"]["kernel_launches"]
    out["raw_run"] = out["replay deployment"]["raw_run"]
    return out


def raw_card_vs_cpu(dev) -> None:
    """Phase 40: the raw LO frame at 512 x 32 on the card and on the CPU,
    every sampler taking every point, on the card-vs-CPU map sizes: with
    the deployment's robust estimator (held as the LO's card-vs-CPU replay
    is) and with the plain one (held as the LIO's)."""
    n_az, n_rings = SMALL_RAYS
    scans = {d.type: odometry_replay.make_scans(RAW_CPU_FRAMES, n_az, n_rings, device=d)
             for d in (torch.device("cpu"), dev)}
    for name, plain, (max_m, max_deg) in (("robust", False, (CPU_TRANS_M, CPU_ROT_DEG)),
                                          ("plain", True, (LIO_CPU_TRANS_M, LIO_CPU_ROT_DEG))):
        finals = {}
        for device in (torch.device("cpu"), dev):
            p, s = scans[device.type]
            params = with_raw(cpu_sized(every_point(odometry_replay.replay_params(p[0]))),
                              range_image_n_az=n_az, range_image_n_rings=n_rings)
            o = odometry_replay.run_replay(plain_estimator(params) if plain else params, p, s, device=device)
            check_replay(f"raw {RAW_CPU_FRAMES}-frame replay ({n_az} x {n_rings}, {name} estimator) on "
                         f"{device.type}", o, 1, MAX_ATE_M)
            finals[device.type] = o["poses"][-1]
        trans, rot = pose_error(finals["cuda"], finals["cpu"])
        print(f"raw LO, card vs CPU plain path after {RAW_CPU_FRAMES} frames ({n_az} x {n_rings}, every point, "
              f"{name} estimator): {trans * 1e3:.4f} mm, {rot:.5f} deg apart (bounds {max_m * 1e3:g} mm, {max_deg} deg)")
        if not (trans <= max_m and rot <= max_deg):
            raise AssertionError(f"the card and the CPU disagree on the raw replay ({name} estimator)")


def api_phase(raw_out, lo_replay_out, dev) -> None:
    """Phase 41: the rest of the API on the card (filters, FPS, prefix sums,
    writers and readers, the native library, timing, profiling, covariance
    markers)."""
    params, poses, scans, _ = lo_replay_out
    raw_lo = raw_out["raw_run"]["odometry"]
    gen_dev = torch.Generator(device=dev).manual_seed(SEED)

    # the facade, SOR and ROR on a full-width voxelized scan with far outliers
    pf = PreprocessFilter(seed=SEED, device=dev)
    outliers = torch.rand(API_OUTLIERS, 3, generator=gen_dev, device=dev) * 20.0 + torch.tensor([0.0, 0.0, 60.0],
                                                                                              device=dev)
    cloud = merge(scans[0], PointCloud(points=outliers, mask=torch.ones(API_OUTLIERS, dtype=torch.bool, device=dev)))
    boxed = pf.box_filter(cloud, 1.0, 80.0)
    vox = voxel_downsample(boxed, VOXEL, out_capacity=voxel_capacity([boxed], VOXEL))
    n_vox = int(vox.count())
    knn = self_knn(vox.points, vox.mask, K)
    far = vox.points[:, 2] > 50.0
    sor = statistical_outlier_removal(vox, knn, 1.0)
    ror = radius_outlier_removal(vox, knn, 1.0, 3)
    cpu_knn = KNNResult(knn.indices.cpu(), knn.distances.cpu())
    cpu_vox = moved(vox, torch.device("cpu"))
    sor_flips = int((sor.mask.cpu() != statistical_outlier_removal(cpu_vox, cpu_knn, 1.0).mask).sum())
    ror_equal = torch.equal(ror.mask.cpu(), radius_outlier_removal(cpu_vox, cpu_knn, 1.0, 3).mask)
    print(f"filters on a full-width scan voxelized at {VOXEL} m ({n_vox} voxels, {int((far & vox.mask).sum())} far "
          f"outliers): SOR keeps {int(sor.count())}, ROR keeps {int(ror.count())}; outliers kept: SOR "
          f"{int((far & sor.mask).sum())}, ROR {int((far & ror.mask).sum())}; against the CPU on the card's k-NN: "
          f"SOR {sor_flips} flips, ROR equal {ror_equal}")
    if int((far & sor.mask).sum()) or int((far & ror.mask).sum()) or not ror_equal:
        raise AssertionError("an outlier filter kept an outlier, or ROR differs from the CPU")
    if int(sor.count()) < 0.8 * n_vox or sor_flips > API_SOR_MAX_FLIPS:
        raise AssertionError(f"SOR kept {int(sor.count())} of {n_vox}, {sor_flips} flips")
    for name, out, num in (("random", pf.random_sampling(vox, 4096), 4096),
                           ("weighted", pf.weighted_random_sampling(vox, torch.ones_like(vox.points[:, 0]), 4096), 4096),
                           ("mixed", pf.mixed_random_sampling(vox, torch.ones_like(vox.points[:, 0]), 4096), 4096)):
        if int(out.count()) != num:
            raise AssertionError(f"the facade's {name} sampling took {int(out.count())} of {num}")

    # farthest-point sampling: time, spread, and the CPU from the same first index
    ms = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fps = pf.farthest_point_sampling(vox, API_FPS)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    first = torch.argmax(torch.where(vox.mask, torch.rand(vox.capacity, generator=gen_dev, device=dev), -1.0))
    on_card = sampling._farthest_point_sampling(vox, API_FPS, first)
    on_cpu = sampling._farthest_point_sampling(cpu_vox, API_FPS, first.cpu())
    sel = fps.points[fps.mask]
    d = torch.cdist(sel, sel)
    d.fill_diagonal_(torch.inf)
    nn = d.min(1).values
    rnd = pf.random_sampling(vox, API_FPS).points
    dr = torch.cdist(rnd, rnd)
    dr.fill_diagonal_(torch.inf)
    print(f"farthest_point_sampling of {API_FPS} from {n_vox}: {statistics.median(ms[1:]):.3f} ms (host clock, "
          f"median of 3 after a warm-up); nearest selected neighbour min {float(nn.min()):.3f} m, median "
          f"{float(nn.median()):.3f} m (a random draw: min {float(dr.min()):.3f}, median "
          f"{float(dr.min(1).values.median()):.3f}); card equal to the CPU from the same first index: "
          f"{torch.equal(on_card.points.cpu(), on_cpu.points)}")
    if not torch.equal(on_card.points.cpu(), on_cpu.points) or float(nn.min()) <= float(dr.min()):
        raise AssertionError("farthest-point sampling differs from the CPU or does not spread")

    # the prefix-sum compaction against compact_device
    compact = scatter_compact(vox.points, vox.mask, vox.capacity)
    ref = compact_device(vox)
    if not torch.equal(compact[ref.mask], ref.points[ref.mask]) or int(compaction_offsets(vox.mask)[1]) != n_vox:
        raise AssertionError("scatter_compact differs from compact_device")
    print(f"prefix sums: scatter_compact of {n_vox} of {vox.capacity} rows equal to compact_device")

    # writers and readers, the native library, covariance markers
    pre = raw_lo.preprocessed
    data = pre.to_numpy()
    with tempfile.TemporaryDirectory() as tmp:
        for name, write in (("binary.ply", lambda p: io.write_ply(p, data)),
                            ("ascii.ply", lambda p: io.write_ply(p, data, binary=False)),
                            ("binary.pcd", lambda p: io.write_pcd(p, data)),
                            ("ascii.pcd", lambda p: io.write_pcd(p, data, binary=False)),
                            ("compressed.pcd", lambda p: io.write_pcd(p, data, compressed=True))):
            path = f"{tmp}/{name}"
            write(path)
            back = io.read_file(path)
            if not np.array_equal(back["points"], data["points"]):
                raise AssertionError(f"{name} did not read back the points written")
        print(f"writers: the raw frame's processed cloud ({len(data['points'])} points) as binary and ascii PLY, "
              f"binary, ascii and binary_compressed PCD, each read back equal")
        if not native_io.available():
            raise AssertionError("the native I/O library could not be built")
        nat = native_io.read_ply(f"{tmp}/binary.ply")
        kitti = f"{tmp}/scan.bin"
        np.concatenate([scans[0].to_numpy()["points"], np.zeros((int(scans[0].count()), 1), np.float32)], 1).tofile(kitti)
        with native_io.PrefetchLoader([kitti, f"{tmp}/binary.ply"]) as loader:
            loaded = list(loader)
        same = (np.array_equal(nat["points"], io.read_ply(f"{tmp}/binary.ply")["points"])
                and np.array_equal(native_io.read_kitti_bin(kitti)["points"], read_kitti_bin(kitti)["points"])
                and np.array_equal(loaded[1]["points"], nat["points"]) and len(loaded) == 2)
        print(f"native_io: built ({native_io.build_library()}), its PLY and KITTI readers and its prefetching "
              f"loader equal to the Python readers: {same}")
        if not same:
            raise AssertionError("the native readers differ from the Python ones")
        verts, faces = covariance_markers.covariance_ellipsoid_mesh(pre, max_markers=API_MARKERS)
        covariance_markers.write_ellipsoid_ply(f"{tmp}/markers.ply", pre, max_markers=API_MARKERS)
        head = open(f"{tmp}/markers.ply", "rb").read(300).decode("ascii", errors="replace")
        print(f"covariance markers of the raw frame's covariances: {len(verts)} vertices, {len(faces)} faces, "
              f"finite {bool(np.isfinite(verts).all())}")
        if f"element face {len(faces)}" not in head or not np.isfinite(verts).all() or len(faces) != 80 * API_MARKERS:
            raise AssertionError("the covariance markers are malformed")

        # StageTimer around frames, and a profiler trace of one raw frame
        raw_params = with_raw(params)
        lo = LidarOdometry(raw_params, device=dev)
        timer = StageTimer()
        for i in range(3):
            timer.measure("raw LO frame", lambda i=i: (lo.process(scans[i], 0.1 * (i + 1)), lo.preprocessed))
        print("StageTimer over 3 raw frames (the first builds the map):\n" + timer.report())
        with profiling.trace(f"{tmp}/trace") as prof:
            with profiling.annotate("raw.frame"):
                lo.process(scans[3], 0.4)
        names = {e.get("name", "") for e in json.load(open(f"{tmp}/trace/trace.json"))["traceEvents"]}
        wanted = ("knn_cluster_kernel<1", "range_image_elevation_kernel", "range_image_cells_kernel",
                  "range_image_tile_kernel", "range_image_rows_kernel")
        kernels = {want: sorted(n for n in names if want in n) for want in wanted + ("raw.frame",)}
        device_ms = {e.key: e.device_time_total / 1e3 for e in prof.key_averages()
                     if any(want in e.key for want in wanted)}
        print(f"profiling.trace of one raw frame: {len(names)} event names; {kernels}; device ms {device_ms}")
        if not all(kernels.values()):
            raise AssertionError(f"the trace misses the cluster nn1 or a range-image kernel: {kernels}")


# -- item 12: the structured searches, the pair preprocess, the device list ------


def grid_replay_phase(lo_out, dev) -> dict:
    """The LO replay with GridKNN submaps (GRID_KNN_TARGET_THRESHOLD lowered
    to 0 for the run) and with brute-force submaps (the default threshold),
    in turns on the LO phase's scans (GRID_TURNS: brute, grid, grid, brute,
    brute, grid): every grid frame after the first a success that launched
    grid_knn and no nn1, ATE <= MAX_ATE_M and within MAX_GRID_ATE_GAP_M of
    the brute-force run; ms a frame (median, max, keyframes and others) of
    each, the host ms of building the target's search structure on a
    keyframe (Submap._target_knn) in each, launches, build_auto's
    rebuilds."""
    params, poses, scans, _ = lo_out["replay"]
    builds = {"build": 0, "build_auto": 0}
    target_ms = []
    real = {name: getattr(GridKNN, name) for name in builds}
    real_target = Submap._target_knn

    def counting(name):
        def call(*args, **kwargs):
            builds[name] += 1
            return real[name](*args, **kwargs)
        return staticmethod(call)

    def timed_target(self, target):
        t0 = time.perf_counter()
        out = real_target(self, target)
        target_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    threshold = knn_module.GRID_KNN_TARGET_THRESHOLD

    def replay(kind: str, n: int = LO_FRAMES) -> dict:
        knn_module.GRID_KNN_TARGET_THRESHOLD = 0 if kind == "grid" else threshold
        builds.update(build=0, build_auto=0)
        target_ms.clear()
        torch.cuda.synchronize()
        cuda_knn.reset_launch_counts()
        out = odometry_replay.run_replay(params, poses[:n], scans[:n], device=dev)
        torch.cuda.synchronize()
        return {"out": out, "launches": dict(cuda_knn.launch_counts), "builds": dict(builds),
                "target_ms": list(target_ms)}

    for name in builds:
        setattr(GridKNN, name, counting(name))
    Submap._target_knn = timed_target
    try:
        replay("grid", LO_WARMUP + 1)
        runs = {"brute": [], "grid": []}
        for kind in GRID_TURNS:
            runs[kind].append(replay(kind))
    finally:
        knn_module.GRID_KNN_TARGET_THRESHOLD = threshold
        for name, fn in real.items():
            setattr(GridKNN, name, staticmethod(fn))
        Submap._target_knn = real_target
    for run in runs["grid"]:
        out, launches = run["out"], run["launches"]
        lo, rows = out["odometry"], out["rows"]
        bad = [r["frame"] for r in rows[1:] if r["result"] != "success"]
        if bad or not isinstance(lo.submap.submap_knn, GridKNN):
            raise AssertionError(f"GridKNN LO replay: frames {bad} failed, target {type(lo.submap.submap_knn).__name__}")
        per_frame = [r["launches"]["grid_knn"] for r in rows[1:]]
        if min(per_frame) <= 0 or launches["nn1"] != 0:
            raise AssertionError(f"GridKNN LO replay: grid_knn a frame {per_frame}, nn1 {launches['nn1']} (must be 0)")
    for run in runs["brute"]:
        check_replay("brute-force LO replay (in turns with the grid)", run["out"], 2, MAX_ATE_M)
        if run["launches"]["grid_knn"] != 0 or run["builds"]["build"] != 0:
            raise AssertionError(f"brute-force LO replay built or searched a grid: {run['launches']}, {run['builds']}")
    grid, brute = runs["grid"][0], runs["brute"][0]
    print_frames(grid["out"])

    def split(kind: str) -> dict:
        """Medians over the kind's runs, frames after the warm-up."""
        rows = [r for run in runs[kind] for r in run["out"]["rows"][LO_WARMUP:]]
        key = [r for run in runs[kind] for r in run["target_ms"]]
        return {"ms_median": statistics.median(r["ms"] for r in rows), "ms_max": max(r["ms"] for r in rows),
                "keyframe_ms": median_of(rows, lambda r: r["ms"], lambda r: r["keyframe"]),
                "other_ms": median_of(rows, lambda r: r["ms"], lambda r: not r["keyframe"]),
                "keyframes": sum(r["keyframe"] for r in rows) // len(runs[kind]),
                "target_build_ms": statistics.median(key) if key else float("nan"),
                "syncs": median_of(rows, lambda r: r["syncs"]),
                "run_medians": [statistics.median(r["ms"] for r in run["out"]["rows"][LO_WARMUP:])
                                for run in runs[kind]],
                "ate_m": [run["out"]["ate_m"] for run in runs[kind]]}

    g, b = split("grid"), split("brute")
    gap = max(abs(x - y) for x in g["ate_m"] for y in b["ate_m"])
    per_frame = [r["launches"]["grid_knn"] for r in grid["out"]["rows"][1:]]
    rebuilds = max(run["builds"]["build"] - run["builds"]["build_auto"] for run in runs["grid"])
    lo = grid["out"]["odometry"]
    print(f"GridKNN LO replay ({LO_FRAMES} x 2048 x 64, threshold 0, cell = max_correspondence_distance "
          f"{params.registration.factor.max_correspondence_distance} m), in turns {GRID_TURNS} with the brute-force "
          f"replay on the same scans: ATE {g['ate_m']} m (brute force {b['ate_m']}, largest gap {gap:.4f}); grid_knn "
          f"a frame after the first {per_frame} (median {statistics.median(per_frame)}); launches {grid['launches']}; "
          f"{grid['builds']['build_auto']} build_auto, {rebuilds} rebuilds; last grid: cell budget "
          f"{lo.submap.submap_knn.max_per_cell}, table {lo.submap.submap_knn.cell_coords.shape[0]} slots")
    for kind, s in (("grid", g), ("brute force", b)):
        print(f"LO frame, {kind} submaps, after {LO_WARMUP} warm-up frames, {len(s['run_medians'])} runs: median "
              f"{s['ms_median']:.3f} ms, max {s['ms_max']:.3f} (run medians "
              f"{[round(x, 3) for x in s['run_medians']]}); keyframes ({s['keyframes']} a run) median "
              f"{s['keyframe_ms']:.3f}, others {s['other_ms']:.3f}; the target's search structure "
              f"(Submap._target_knn) {s['target_build_ms']:.3f} host ms a keyframe; host syncs a frame median "
              f"{s['syncs']}")
    if not (max(g["ate_m"]) <= MAX_ATE_M and gap <= MAX_GRID_ATE_GAP_M):
        raise AssertionError(f"GridKNN LO replay: ATE {g['ate_m']} m, gap {gap:.4f} m to brute force")
    return {"launches": grid["launches"], "per_frame": statistics.median(per_frame), "grid": g, "brute": b,
            "rebuilds": rebuilds}


def spread_rows(points: torch.Tensor, mask: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` valid rows taken evenly over the cloud, contiguous."""
    valid = points[mask]
    return valid[torch.linspace(0, valid.shape[0] - 1, n, device=points.device).long()].contiguous()


def world_cloud(scans, poses, dev) -> PointCloud:
    """Scans moved into the world by their poses, merged."""
    pts = [transform_points(s.points, torch.as_tensor(np.asarray(T, np.float32), device=dev))
           for s, T in zip(scans, poses)]
    return PointCloud(points=torch.cat(pts).contiguous(), mask=torch.cat([s.mask for s in scans]).contiguous())


def check_grid_kernel(lo_out, grid_out, dev) -> list:
    """grid_knn (kernel A, a lane group a query) at the lanes grid_lanes
    picks and at each of GRID_LANES, and its first design (one thread a
    query), against the plain search, bit for bit, at the LO frame's shapes
    (1,000 and 5,000 queries against the 16,384-row submap) and the
    coarse-to-fine shapes (30,000 against 4,096 and 16,384 rows), with a
    query with no neighbour and one outside the 21-bit range added, and on
    an all-masked target; timed in turns (the kernel at its lanes and at
    each lane count, the first design, the plain version and nn1 / knn_k on
    the same target), with its bound."""
    params, poses, scans, _ = lo_out["replay"]
    cell = params.registration.factor.max_correspondence_distance
    target, pose = lo_out["targets"]["last keyframe"]
    odd = torch.tensor([[1e3, 1e3, 1e3], [5e6, 0.0, 0.0]], device=dev)
    q1000 = torch.cat([lo_out["queries"], odd]).contiguous()
    q5000 = spread_rows(lo_out["scan"].points, lo_out["scan"].mask, 5000)
    q30000 = spread_rows(scans[-1].points, scans[-1].mask, 30000)
    coarse = PointCloud(points=target.points[::4].contiguous(), mask=target.mask[::4].contiguous())
    shapes_in = {"LO 1,000 queries": (q1000, target, pose, 1), "LO 5,000 queries": (q5000, target, pose, 1),
                 "LO 5,000 queries, k=10": (q5000, target, None, K),
                 "C2F 30,000 against 4,096": (q30000, coarse, pose, 1),
                 "C2F 30,000 against 16,384": (q30000, target, pose, 1)}
    shapes = {}
    for label, (q, tgt, T, k) in shapes_in.items():
        grid = GridKNN.build_auto(tgt, cell_size=cell)
        cases = {"path": grid, "all masked": GridKNN.build(tgt.replace(mask=torch.zeros_like(tgt.mask)), cell)}
        for what, g in cases.items():
            ref = grid_knn.grid_search_plain(g, q, k, T)
            for lanes in (None, *cuda_knn.GRID_LANES):
                got = grid_knn.grid_search(g, q, k, T, lanes=lanes)
                torch.cuda.synchronize()
                check_equal("grid_knn", got, ref, f"{label}, {what}, lanes {lanes or 'planned'}")
            check_equal("grid_knn_simple", grid_knn.grid_search_simple(g, q, k, T), ref, f"{label}, {what}")
        t, m = tgt.points.contiguous(), tgt.mask
        prep = cuda_knn.prep_target(t, m)
        C, M, Q = grid.cell_coords.shape[0], t.shape[0], q.shape[0]
        lanes = cuda_knn.grid_lanes(Q, n_sm())
        turns = in_turns({"plain_ms": lambda: grid_knn.grid_search_plain(grid, q, k, T),
                          "ms": lambda: grid_knn.grid_search(grid, q, k, T),
                          "previous_ms": lambda: grid_knn.grid_search_simple(grid, q, k, T),
                          "yardstick_ms": (lambda: cuda_knn.nn1_prepped(prep, q, T)) if k == 1 else
                          (lambda: cuda_knn.knn_k_prepped(prep, q, k)),
                          **{f"lanes_{g}_ms": (lambda g=g: grid_knn.grid_search(grid, q, k, T, lanes=g))
                             for g in cuda_knn.GRID_LANES}})
        build_ms, build_syncs = host_ms(lambda: GridKNN.build_auto(tgt, cell_size=cell))
        _, valid, idx = grid_knn.grid_candidates(grid, q, T)
        # what the search must touch: the queries, the pose and the outputs;
        # 17 B (point, mask, original index) for each distinct row of a found
        # cell that holds a candidate; the used flags and 20 B (key, start,
        # count) for each occupied slot
        rows = int(torch.unique(idx[valid]).numel())
        occupied = int(grid.cell_used.sum())
        sb = bound(int(valid.sum()), 12 * Q + (64 if T is not None else 0) + 8 * Q * k + 17 * rows + C + 20 * occupied)
        shapes[label] = {"Q": Q, "M": M, "valid": int(m.sum()), "k": k, "cells": C, "cells_used": occupied,
                         "rows_touched": rows, "max_per_cell": grid.max_per_cell, "pairs": int(valid.sum()),
                         "lanes": lanes, **turns, "build_ms": build_ms, "build_syncs": build_syncs,
                         "bound_ms": sb[0], "bound_by": sb[1]}
        print(f"grid_knn ({label}: Q={Q}, M={M}, valid {int(m.sum())}, k={k}, budget {grid.max_per_cell}, "
              f"{occupied} of {C} slots used, {rows} rows in the cells found, {int(valid.sum())} candidate pairs): "
              f"the lane-group kernel (at {lanes} lanes a query, planned, and at each of {cuda_knn.GRID_LANES}) and "
              f"the first design equal to the plain version bit for bit (all masked, a query with no neighbour and "
              f"one off the 21-bit range too); marginal CUDA-event ms per launch, medians in turns: kernel "
              f"{turns['ms']:.4f} ("
              + ", ".join(f"{g} lanes {turns[f'lanes_{g}_ms']:.4f}" for g in cuda_knn.GRID_LANES)
              + f"), first design {turns['previous_ms']:.4f}, plain {turns['plain_ms']:.4f}, "
              f"{'nn1' if k == 1 else 'knn_k'} on the same target {turns['yardstick_ms']:.4f}; kernel / first design "
              f"{turns['ms'] / turns['previous_ms']:.3f}, kernel / {'nn1' if k == 1 else 'knn_k'} "
              f"{turns['ms'] / turns['yardstick_ms']:.3f}; build_auto {build_ms:.3f} host ms ({build_syncs} syncs); "
              f"bound {sb[0]:.6f} ({sb[1]}); no library call computes this search")
    path = shapes["LO 1,000 queries"]
    out = [
        row("grid_knn", GRID_SOURCE, GRID_REPLACES, GRID_PATH, 0.0, (path["ms"], path["plain_ms"], None),
            (path["bound_ms"], path["bound_by"]), previous_ms=path["previous_ms"], shapes=shapes,
            library="none computes it", launches=grid_out["launches"]["grid_knn"]),
        row("grid_knn_simple", GRID_SOURCE, GRID_REPLACES, GRID_PATH, 0.0,
            (path["previous_ms"], path["plain_ms"], None), (path["bound_ms"], path["bound_by"]),
            library="none computes it", launches=grid_out["launches"]["grid_knn_simple"]),
    ]
    # the instances above 16 at the LO frame's 5,000 queries against the submap
    grid = GridKNN.build_auto(target, cell_size=cell)
    _, valid, idx = grid_knn.grid_candidates(grid, q5000)
    rows_touched, occupied = int(torch.unique(idx[valid]).numel()), int(grid.cell_used.sum())
    Q, C, pairs = q5000.shape[0], grid.cell_coords.shape[0], int(valid.sum())
    out += instance_rows(
        "grid_knn", GRID_SOURCE, GRID_REPLACES, "GridKNN.search", cuda_knn.LARGE_K,
        lambda k: grid_knn.grid_search(grid, q5000, k),
        lambda k, got: check_equal("grid_knn", got, grid_knn.grid_search_plain(grid, q5000, k),
                                   f"LO 5,000 queries, k={k}"),
        lambda k: grid_knn.grid_search_plain(grid, q5000, k),
        lambda k: bound(pairs, 12 * Q + 8 * Q * k + 17 * rows_touched + C + 20 * occupied),
        lambda big: driven("grid_knn", lambda: grid.search(q5000, big)))
    return out


def pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def driven(name: str, call) -> int:
    """Launches counted under ``name`` in one ``call()`` made with the counts
    at 0."""
    torch.cuda.synchronize()
    cuda_knn.reset_launch_counts()
    call()
    torch.cuda.synchronize()
    return cuda_knn.launch_counts[name]


def instance_rows(name, source, replaces, path, ks, search, check, plain, bound_of, launches_of,
                  library=None, variants=None) -> list:
    """The rows of a kernel's instances above FAST_MAX_K (one a K of
    cuda_knn.LARGE_K, at the largest k of ``ks`` that K serves, k = K but
    where the search has fewer candidates; any other k of ``ks`` in the
    shapes of its instance's row): at each k of ``ks``, ``check(k, search(k))`` holds the
    kernel to its plain version, then in turns the kernel at k, at k = K
    (10), ``library(k)`` (where one computes the same function) and each
    of ``variants`` (name -> call of k: the kernel at another launch
    shape), the plain version once, and ``bound_of(k)``; ``launches_of(K)``
    the row's launches."""
    dev = torch.device("cuda", torch.cuda.current_device())
    per_k = {}
    for k in ks:
        got = search(k)
        torch.cuda.synchronize()
        check(k, got)
        fns = {"ms": lambda: search(k), "k10_ms": lambda: search(K)}
        if library is not None:
            fns["library_ms"] = lambda: library(k)
        for v, call in (variants or {}).items():
            fns[v] = lambda call=call: call(k)
        t = in_turns(fns)
        t["plain_ms"] = marginal_ms(lambda: plain(k), dev)
        sb = bound_of(k)
        per_k[k] = {**t, "bound_ms": sb[0], "bound_by": sb[1]}
        print(f"{name} at k={k} (instance K={cuda_knn.instance_k(k)}, {path}): equal to its plain version bit for "
              f"bit; marginal CUDA-event ms, medians in turns: kernel {t['ms']:.4f}, at k={K} {t['k10_ms']:.4f} "
              f"(x{t['ms'] / t['k10_ms']:.2f})"
              + (f", library {t['library_ms']:.4f} (kernel / library {t['ms'] / t['library_ms']:.3f})"
                 if library is not None else ", no library call computes it")
              + "".join(f", {v} {t[v]:.4f}" for v in variants or {})
              + f", plain {t['plain_ms']:.4f}; bound {sb[0]:.6f} ({sb[1]})")
    rows = []
    for big in cuda_knn.LARGE_K:
        top = max(k for k in ks if cuda_knn.instance_k(k) == big)
        r = per_k[top]
        rows.append(row(f"{name} (K={big})", source, replaces, path, 0.0,
                        (r["ms"], r["plain_ms"], r.get("library_ms")), (r["bound_ms"], r["bound_by"]),
                        launches=launches_of(big), k10_ms=r["k10_ms"], k=top,
                        **{v: r[v] for v in variants or {}},
                        shapes={f"k={k}": per_k[k] for k in ks if cuda_knn.instance_k(k) == big}))
    return rows


def with_neighbors(params, k: int, raw: bool = False):
    """``params`` with the covariances' neighbor_num at ``k``; ``raw`` takes
    them from the raw scan's range image with the plain estimator (the
    robust one's IRLS on ring neighbourhoods spreads the raw frames' ATE
    with the sampling draw: RAW_BOUNDS)."""
    ce = dataclasses.replace(params.covariance_estimation, neighbor_num=k)
    if raw:
        ce = dataclasses.replace(ce, raw_range_image=True,
                                 m_estimation=dataclasses.replace(ce.m_estimation, enable=False))
    return dataclasses.replace(params, covariance_estimation=ce)


def large_k_frames(lo_out, dev) -> dict:
    """Phase 45: the full-width LO replay of phase 7's scans with
    neighbor_num at LARGE_NEIGHBORS: the standard covariances (the scan's
    and each keyframe's knn_k at k = 20, the K = 32 instance) and the raw
    range-image ones (the window's K = 32 instance) with the plain
    estimator, each under LARGE_SEEDS, each run with the counts at 0 just
    before and read just after. Prints ms a frame and launches a frame (the
    first seed's run) and the ATE beside JAX's; fails unless every frame
    after the first succeeds, the median ATE is within LARGE_MAX_ATE_M and
    the frame's kernels launched."""
    params, poses, scans, _ = lo_out["replay"]
    out = {}
    for name, p, kernel in (("standard", with_neighbors(params, LARGE_NEIGHBORS), "knn_k"),
                            ("raw", with_neighbors(params, LARGE_NEIGHBORS, raw=True), "range_image")):
        odometry_replay.run_replay(p, poses[:LO_WARMUP + 1], scans[:LO_WARMUP + 1], device=dev)  # warms the instance
        runs = []
        for seed in LARGE_SEEDS:
            torch.cuda.synchronize()
            cuda_knn.reset_launch_counts()
            o = odometry_replay.run_replay(p, poses, scans, device=dev, seed=seed)
            torch.cuda.synchronize()
            runs.append((o, dict(cuda_knn.launch_counts)))
            bad = [r["frame"] for r in o["rows"][1:] if r["result"] != "success"]
            if bad:
                raise AssertionError(f"LO at neighbor_num {LARGE_NEIGHBORS} ({name}, seed {seed}): frames {bad} "
                                     f"did not succeed")
        o, launches = runs[0]
        rows = o["rows"][LO_WARMUP:]
        ates = [r[0]["ate_m"] for r in runs]
        ate = statistics.median(ates)
        per = {k: sum(r["launches"][k] for r in o["rows"][1:]) / (len(o["rows"]) - 1) for k in FRAME_KERNELS}
        ms = [r["ms"] for r in rows]
        print(f"LO replay (2048 x 64, full width) at neighbor_num {LARGE_NEIGHBORS}, {name} covariances"
              + (" (plain estimator)" if name == "raw" else "") + f": median {statistics.median(ms):.3f} ms a "
              f"frame, max {max(ms):.3f} (frames {LO_WARMUP}-{len(o['rows']) - 1}); launches a frame after the "
              f"first: " + ", ".join(f"{k} {v:.2f}" for k, v in per.items()) + f"; launches in all {launches}; ATE "
              f"median {ate:.4f} m over seeds {LARGE_SEEDS}, all {[round(a, 4) for a in ates]} (bound "
              f"{LARGE_MAX_ATE_M[name]} m; the JAX package's on these scans on the CPU at its seeds "
              f"{JAX_LARGE_ATE_M[name]} m)")
        if not ate <= LARGE_MAX_ATE_M[name]:
            raise AssertionError(f"LO at neighbor_num {LARGE_NEIGHBORS} ({name}): ATE {ate:.4f} m above "
                                 f"{LARGE_MAX_ATE_M[name]}")
        if min(launches[kernel], launches["nn1"]) <= 0:
            raise AssertionError(f"LO at neighbor_num {LARGE_NEIGHBORS} ({name}): a kernel of the frame never "
                                 f"launched: {launches}")
        out[name] = {"ms": statistics.median(ms), "max_ms": max(ms), "ate_m": ate, "ates": ates,
                     "launches": launches, "per_frame": per}
    return out


def check_large_k(lo_out, frames: dict, dev) -> list:
    """Phase 45's kernels at each k of LARGE_KS: knn_k on the LO frame's
    preprocessed scan (its self-search), knn_k_batched on LARGE_BATCH
    streams of that scan (stream b masks every LARGE_BATCH-th row from b)
    and the range-image window on the raw full-width scan. Bit for bit:
    knn_k and each stream of knn_k_batched against knn_k_sorted_plain (the
    first design stops at 16), the one-thread instances (knn_k_spill) and one
    launch a stream, the window against its plain version; the first 16
    columns against the k = 16 search. Timed in turns with k = K (10), with
    knn_k_spill and with cdist + topk at the same k (a stream at a time for
    the batched entry); bounds. Launches: the frame
    runs' for K = 32 (k = 20), one call of the public entry for K = 64 and
    128 (and the batched entry's K = 32)."""
    pts, mask = lo_out["scan"].points.contiguous(), lo_out["scan"].mask
    n, valid = pts.shape[0], int(mask.sum())
    prep = cuda_knn.prep_target(pts, mask)
    t_inf = inf_masked(pts, mask)
    B = LARGE_BATCH
    bmask = torch.stack([mask & (torch.arange(n, device=dev) % B != b) for b in range(B)]).contiguous()
    bpts = pts.expand(B, n, 3).contiguous()
    bprep = cuda_knn.prep_targets(bpts, bmask)
    b_inf = torch.where(bmask[..., None], bpts, torch.inf)
    b_valid = [int(m.sum()) for m in bmask]
    box = lo_out["replay"][0].scan.preprocess.box_filter
    raw = box_filter(lo_out["replay"][2][-1], box.min, box.max)
    ce = CovarianceEstimationParams()
    n_az, n_rings, w_az, w_el = (ce.range_image_n_az, ce.range_image_n_rings, ce.range_image_window_az,
                                 ce.range_image_window_el)
    rp, rm = raw.points.contiguous(), raw.mask.contiguous()
    ri = range_image_knn
    img_p, img_i, _, _, _ = ri.range_image(rp, rm, n_az, n_rings)
    C = n_az * n_rings
    wpairs = window_pairs(img_i, n_az, n_rings, w_az, w_el)

    def first16(name, got, k16):
        if not (torch.equal(got[0][..., :16], k16[0]) and torch.equal(got[1][..., :16], k16[1])):
            raise AssertionError(f"{name}: the first 16 columns differ from the k = 16 search")

    k16 = cuda_knn.knn_k_prepped(prep, pts, 16)

    def check_knn(k, got):
        check_equal("knn_k", got, cuda_knn.knn_k_sorted_plain(pts, mask, pts, k), f"the LO scan, k={k}")
        check_equal("knn_k", got, cuda_knn.knn_k_spill(prep, pts, k), f"the one-thread instance (knn_k_spill), k={k}")
        first16(f"knn_k at k={k}", got, k16)

    b16 = cuda_knn.knn_k_batched(bprep, bpts, 16)

    def check_batched(k, got):
        for b in range(B):
            one = (got[0][b], got[1][b])
            check_equal("knn_k_batched", one, cuda_knn.knn_k_prepped(cuda_knn.prep_target(bpts[b], bmask[b]),
                                                                     bpts[b], k), f"stream {b}, k={k}")
            check_equal("knn_k_batched", one, cuda_knn.knn_k_sorted_plain(bpts[b], bmask[b], bpts[b], k),
                        f"stream {b} against the tie-ordered plain version, k={k}")
        check_equal("knn_k_batched", got, cuda_knn.knn_k_spill(bprep, bpts, k),
                    f"the one-thread instance (knn_k_spill), k={k}")
        first16(f"knn_k_batched at k={k}", got, b16)

    w16 = ri.range_image_window(img_p, img_i, n_az, n_rings, w_az, w_el, 16)
    W = ri.window_candidates(w_az, w_el)
    win_ks = tuple(min(k, W) for k in LARGE_KS)  # the default window holds 117 candidates: K = 128 at k = 117
    win = (img_p, img_i, n_az, n_rings, w_az, w_el)

    def check_window(k, got):
        check_equal("range_image", got, ri.range_image_window_plain(*win, k), f"the full-width image, k={k}")
        check_equal("range_image", got, ri.range_image_window_spill(*win, k),
                    f"the one-thread instance (range_image_window_spill), k={k}")
        first16(f"range_image at k={k}", got, w16)

    cd = "donot_use_mm_for_euclid_dist"
    print(f"phase 45 kernels: the LO scan Q=M={n} ({valid} valid), {B} streams of it ({b_valid} valid), the raw "
          f"scan's {n_az} x {n_rings} image ({int((img_i >= 0).sum())} cells occupied, {wpairs} window pairs)")
    rows = instance_rows(
        "knn_k", KNN_SOURCE, "sycl_points_tpu/ops/knn.py:223", LARGE_PATH, LARGE_KS,
        lambda k: cuda_knn.knn_k_prepped(prep, pts, k), check_knn, lambda k: cuda_knn.knn_k_plain(pts, mask, pts, k),
        lambda k: knn_bound(n, n, valid, k),
        lambda big: frames["standard"]["launches"]["knn_k"] if big == 32 else
        driven("knn_k", lambda: self_knn(pts, mask, big)),
        library=lambda k: torch.cdist(pts, t_inf, compute_mode=cd).topk(k, largest=False),
        variants={"spill_ms": lambda k: cuda_knn.knn_k_spill(prep, pts, k)})
    rows += instance_rows(
        "knn_k_batched", KNN_SOURCE, "sycl_points_tpu/parallel/fleet.py:133", "self_knn_streams", LARGE_KS,
        lambda k: cuda_knn.knn_k_batched(bprep, bpts, k), check_batched,
        lambda k: cuda_knn.knn_k_batched_plain(bpts, bmask, bpts, k),
        lambda k: bound(n * sum(b_valid), B * (13 * n + 12 * n + 8 * n * k)),
        lambda big: driven("knn_k_batched", lambda: knn_module.self_knn_streams(bpts, bmask, big)),
        library=lambda k: [torch.cdist(bpts[b], b_inf[b], compute_mode=cd).topk(k, largest=False)
                           for b in range(B)],
        variants={"spill_ms": lambda k: cuda_knn.knn_k_spill(bprep, bpts, k)})
    # the one-thread instances (spilled lists), timed in the same turns
    rows += [row(r["name"].replace("knn_k_batched", "knn_k_spill (batched)").replace("knn_k (", "knn_k_spill ("),
                 KNN_SOURCE, r["replaces"], "timing only (the one-thread design)", 0.0,
                 (r["shapes"][f"k={big}"]["spill_ms"], r["plain_ms"], r["library_ms"]), (r["bound_ms"], r["bound_by"]),
                 launches=0) for big, r in zip(2 * cuda_knn.LARGE_K, rows)]
    before = dict(cuda_knn.launch_counts)
    for call in (lambda k: ri.range_image_knn(rp, rm, k), lambda k: ri.range_image_window_plain(*win, k),
                 lambda k: ri.range_image_window(*win, k)):
        try:
            call(W + 1)
        except ValueError as e:
            if "candidates" not in str(e):
                raise
        else:
            raise AssertionError(f"the range-image search took k = {W + 1} above its window's {W} candidates")
    if cuda_knn.launch_counts != before:
        raise AssertionError("a refused range-image search launched")
    print(f"range_image: k = {W + 1} above the window's {W} candidates refused (ValueError) before any launch")
    win_rows = instance_rows(
        "range_image", RAW_SOURCE, RAW_REPLACES, LARGE_RAW_PATH, win_ks,
        lambda k: ri.range_image_window(*win, k), check_window, lambda k: ri.range_image_window_plain(*win, k),
        lambda k: bound(wpairs, C * 16 + C * k * 8),
        lambda big: frames["raw"]["launches"]["range_image"] if big == 32 else
        driven("range_image", lambda: ri.range_image_knn(rp, rm, min(big, W))),
        variants={"spill_ms": lambda k: ri.range_image_window_spill(*win, k)})
    rows += win_rows
    rows += [row(r["name"].replace("range_image (", "range_image_spill ("), RAW_SOURCE, r["replaces"],
                 "timing only (the one-thread design)", 0.0, (r["spill_ms"], r["plain_ms"], None),
                 (r["bound_ms"], r["bound_by"]), launches=0, k=r["k"]) for r in win_rows]
    return rows


def rank_bound(Q: int, occupied: int, C: int, P: int):
    """The ranking's bound: RANK_OPS FP32 operations a (query, occupied
    cell) pair; reads the queries and each cell's centroid, radius and
    flag once, writes the cells and the unexplored bound."""
    return bound(-(-Q * occupied * RANK_OPS // OPS_PER_PAIR), 12 * Q + 17 * C + 4 * Q * P + 4 * Q)


def coarse_turns(ck: CoarseKNN, q: torch.Tensor, prep, cells, lb, plain: bool) -> dict:
    """In turns: the search (two launches), the first sequence (the matmul +
    topk ranking, then the first refine design), nn1 on the same target,
    the ranking and the refine (at its planned lanes and at each of
    GRID_LANES) each beside its first design, and (``plain``) the refine's
    and the ranking's plain versions."""
    fns = {"search_ms": lambda: ck.search(q, 1, top_cells=COARSE_P),
           "first_search_ms": lambda: coarse_knn.coarse_refine_simple(
               ck, q, *coarse_knn.rank_cells_matmul(ck, q, COARSE_P, 1e-2), 1),
           "nn1_ms": lambda: cuda_knn.nn1_prepped(prep, q),
           "rank_ms": lambda: coarse_knn.coarse_rank(ck, q, COARSE_P, 1e-2),
           "first_rank_ms": lambda: coarse_knn.rank_cells_matmul(ck, q, COARSE_P, 1e-2),
           "ms": lambda: coarse_knn.coarse_refine(ck, q, cells, lb, 1),
           "previous_ms": lambda: coarse_knn.coarse_refine_simple(ck, q, cells, lb, 1),
           **{f"lanes_{g}_ms": (lambda g=g: coarse_knn.coarse_refine(ck, q, cells, lb, 1, lanes=g))
              for g in cuda_knn.GRID_LANES}}
    if plain:
        fns["plain_ms"] = lambda: coarse_knn.coarse_refine_plain(ck, q, cells, lb, 1)
        fns["rank_plain_ms"] = lambda: coarse_knn.rank_cells_plain(ck, q, COARSE_P, 1e-2)
    return in_turns(fns)


def check_coarse(ck: CoarseKNN, q: torch.Tensor, label: str, plain_rows: slice) -> dict:
    """One CoarseKNN build: ``CoarseKNN.search`` driven with the counts at 0
    (its launches: coarse_rank and coarse_refine, one each), the certified
    fraction and every certified row equal to nn1; coarse_rank bit for bit
    against its plain version, PR 14's matmul ranking beside it; the refine
    and its first design bit for bit against the plain refine on the
    ``plain_rows`` queries (k = 1 and K); the turns of :func:`coarse_turns`
    and the bounds."""
    torch.cuda.synchronize()
    cuda_knn.reset_launch_counts()
    res, cert = ck.search(q, 1, top_cells=COARSE_P)
    torch.cuda.synchronize()
    launches = {name: cuda_knn.launch_counts[name] for name in ("coarse_rank", "coarse_refine")}
    if launches != {"coarse_rank": 1, "coarse_refine": 1}:
        raise AssertionError(f"CoarseKNN ({label}): the search launched {launches}")
    prep = cuda_knn.prep_target(ck.points, ck.mask)
    ref_i, ref_d = cuda_knn.nn1_prepped(prep, q)
    c = cert.bool()
    d_bad = int((res.distances[c, 0] != ref_d[c]).sum())
    i_bad = cuda_knn.nn1_mismatches(res.indices[c, 0], res.distances[c, 0], ref_i[c], ref_d[c], TIE_TOL)
    if d_bad or i_bad:
        raise AssertionError(f"CoarseKNN ({label}): {d_bad} certified distances and {i_bad} indices differ from nn1")
    cells, lb = coarse_knn.coarse_rank(ck, q, COARSE_P, 1e-2)
    ref_cells, ref_lb = coarse_knn.rank_cells_plain(ck, q, COARSE_P, 1e-2)
    torch.cuda.synchronize()
    if not (torch.equal(cells, ref_cells) and torch.equal(lb, ref_lb)):
        raise AssertionError(f"coarse_rank ({label}) differs from its plain version: "
                             f"{int((cells != ref_cells).any(1).sum())} rows of cells, "
                             f"{int((lb != ref_lb).sum())} bounds")
    del ref_cells, ref_lb
    mm_cells, mm_lb = coarse_knn.rank_cells_matmul(ck, q, COARSE_P, 1e-2)
    mm_rows = int((mm_cells != cells).any(1).sum())
    mm_err = float((mm_lb - lb).abs()[torch.isfinite(lb)].max()) if bool(torch.isfinite(lb).any()) else 0.0
    del mm_cells, mm_lb
    part = plain_rows
    for kk in (1, K):
        args = (ck, q[part].contiguous(), cells[part].contiguous(), lb[part].contiguous(), kk)
        ref = coarse_knn.coarse_refine_plain(*args)
        for fn in (coarse_knn.coarse_refine, coarse_knn.coarse_refine_simple):
            got = fn(*args)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                raise AssertionError(f"{fn.__name__} ({label}, k={kk}) differs from its plain version")
    turns = coarse_turns(ck, q, prep, cells, lb, plain=part.stop is None)
    valid, _ = coarse_knn.coarse_candidates(ck, cells)
    C, M, Q = ck.centroids.shape[0], ck.points.shape[0], q.shape[0]
    occupied = int(ck.occupied)
    sb = bound(int(valid.sum()), 12 * Q + 4 * Q * COARSE_P + 4 * Q + 13 * M + 9 * C + 8 * Q + Q)
    rb = rank_bound(Q, occupied, C, COARSE_P)
    frac = float(cert.float().mean())
    lanes = cuda_knn.refine_lanes(COARSE_P * ck.max_per_cell, 1)
    print(f"CoarseKNN ({label}: Q={Q}, M={M}, valid {int(ck.mask.sum())}, {occupied} of {C} cells occupied, the "
          f"fullest {int(ck.counts.max())} points, budget {ck.max_per_cell}, overflow {int(ck.overflow)}, "
          f"{COARSE_CELL} m cells, top {COARSE_P} cells, {int(valid.sum())} candidate pairs): search launches "
          f"{launches}; certified {frac:.4f}, certified rows equal to nn1; coarse_rank equal to its plain version "
          f"bit for bit (PR 14's matmul ranking selects other cells in {mm_rows} rows, bounds apart by up to "
          f"{mm_err:.3g}); the refine ({lanes} lanes a query) and its first design equal to the plain refine bit "
          f"for bit (k=1 and k={K}); marginal CUDA-event ms, medians in turns: whole search "
          f"{turns['search_ms']:.4f} (the first sequence {turns['first_search_ms']:.4f}, nn1 on the same target "
          f"{turns['nn1_ms']:.4f}; search / nn1 {turns['search_ms'] / turns['nn1_ms']:.3f}), ranking "
          f"{turns['rank_ms']:.4f} (PR 14's matmul + topk {turns['first_rank_ms']:.4f}"
          + (f", plain {turns['rank_plain_ms']:.4f}" if "rank_plain_ms" in turns else "")
          + f"; bound {rb[0]:.4f} ({rb[1]})), refine {turns['ms']:.4f} ("
          + ", ".join(f"{g} lanes {turns[f'lanes_{g}_ms']:.4f}" for g in cuda_knn.GRID_LANES)
          + f"; first design {turns['previous_ms']:.4f}"
          + (f", plain {turns['plain_ms']:.4f}" if "plain_ms" in turns else "")
          + f"; bound {sb[0]:.4f} ({sb[1]})); no library call computes this search")
    return {"Q": Q, "M": M, "valid": int(ck.mask.sum()), "cells": C, "cells_occupied": occupied,
            "fullest": int(ck.counts.max()), "max_per_cell": ck.max_per_cell, "overflow": int(ck.overflow),
            "pairs": int(valid.sum()), "certified": frac, "lanes": lanes, "launches": launches,
            "matmul_rank_rows_differ": mm_rows, **turns, "bound_ms": sb[0], "bound_by": sb[1],
            "rank_bound_ms": rb[0], "rank_bound_by": rb[1]}


def check_coarse_kernel(lo_out, dev) -> list:
    """coarse_rank and coarse_refine (kernel B and its ranking) at
    C2F_QUERIES queries against 131,072 (one scan) and 1,048,576 rows
    (eight), built from the LO phase's scans moved into the world, at JAX's
    default capacity and at a build sized to the data (the capacity the
    power of two above the occupied cells, the budget the power of two
    above the fullest cell, so nothing overflows): :func:`check_coarse` on
    each; an all-masked target through both kernels; the K > 16 instances
    of the refine at the 131,072-row default build."""
    _, poses, scans, _ = lo_out["replay"]
    q = transform_points(spread_rows(scans[-1].points, scans[-1].mask, C2F_QUERIES),
                         torch.as_tensor(np.asarray(poses[-1], np.float32), device=dev)).contiguous()
    shapes, launches = {}, {"coarse_rank": 0, "coarse_refine": 0}
    for label, n in (("131,072 rows", 1), ("1,048,576 rows", 8)):
        cloud = world_cloud(scans[:n], poses[:n], dev)
        ck = CoarseKNN.build(cloud, COARSE_CELL, max_per_cell=COARSE_L)
        out = check_coarse(ck, q, f"{label}, the default capacity", slice(None))
        shapes[label] = out
        for name in launches:
            launches[name] += out["launches"][name]
        used, fullest = int(ck.valid.sum()) + int(ck.cells_lost), int(ck.counts.max())
        C, L = max(pow2(used), 2 * COARSE_P), pow2(fullest)
        sized = CoarseKNN.build(cloud, COARSE_CELL, cells_capacity=C, max_per_cell=L)
        over = (int(sized.overflow), int(sized.cells_lost), int(sized.points_lost))
        if over != (0, 0, 0):
            raise AssertionError(f"CoarseKNN ({label}) sized to the data overflows: {over}")
        shapes[f"{label}, sized to the data"] = check_coarse(sized, q, f"{label}, sized to the data",
                                                             slice(0, COARSE_PLAIN_QUERIES))
        if n == 1:
            empty = CoarseKNN.build(cloud.replace(mask=torch.zeros_like(cloud.mask)), COARSE_CELL,
                                    max_per_cell=COARSE_L)
            e_cells, e_lb = coarse_knn.coarse_rank(empty, q, COARSE_P, 1e-2)
            ref_cells, ref_lb = coarse_knn.rank_cells_plain(empty, q, COARSE_P, 1e-2)
            got = coarse_knn.coarse_refine(empty, q, e_cells, e_lb, 1)
            ref = coarse_knn.coarse_refine_plain(empty, q, ref_cells, ref_lb, 1)
            if not (torch.equal(e_cells, ref_cells) and torch.equal(e_lb, ref_lb)
                    and all(torch.equal(a, b) for a, b in zip(got, ref)) and bool(torch.isinf(got[1]).all())):
                raise AssertionError("the CoarseKNN kernels on an all-masked target differ from their plain versions")
            big = ck
    path, sized = shapes["131,072 rows"], shapes["1,048,576 rows, sized to the data"]
    rows = [
        row("coarse_rank", COARSE_SOURCE, COARSE_RANK_REPLACES, COARSE_PATH, 0.0,
            (path["rank_ms"], path["rank_plain_ms"], None), (path["rank_bound_ms"], path["rank_bound_by"]),
            shapes=shapes, previous_ms=path["first_rank_ms"], library="none computes it",
            launches=launches["coarse_rank"]),
        row("coarse_refine", COARSE_SOURCE, COARSE_REPLACES, COARSE_PATH, 0.0, (path["ms"], path["plain_ms"], None),
            (path["bound_ms"], path["bound_by"]), previous_ms=path["previous_ms"], library="none computes it",
            launches=launches["coarse_refine"], sized_1m_ms=sized["ms"], sized_1m_previous_ms=sized["previous_ms"]),
        row("coarse_refine_simple", COARSE_SOURCE, COARSE_REPLACES, COARSE_PATH, 0.0,
            (path["previous_ms"], path["plain_ms"], None), (path["bound_ms"], path["bound_by"]),
            library="none computes it", launches=0),
    ]
    # the refine's instances above 16, at the 131,072-row default build
    ck = big
    cells, lb = coarse_knn.coarse_rank(ck, q, COARSE_P, 1e-2)
    M, Q = ck.points.shape[0], q.shape[0]
    valid, _ = coarse_knn.coarse_candidates(ck, cells)
    pairs = int(valid.sum())

    def check(k, got):
        ref = coarse_knn.coarse_refine_plain(ck, q, cells, lb, k)
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"coarse_refine at k={k} differs from its plain version")

    rows += instance_rows(
        "coarse_refine", COARSE_SOURCE, COARSE_REPLACES, COARSE_PATH, cuda_knn.LARGE_K,
        lambda k: coarse_knn.coarse_refine(ck, q, cells, lb, k), check,
        lambda k: coarse_knn.coarse_refine_plain(ck, q, cells, lb, k),
        lambda k: bound(pairs, 12 * Q + 4 * Q * COARSE_P + 4 * Q + 13 * M + 9 * ck.centroids.shape[0] + 8 * Q * k + Q),
        lambda big: driven("coarse_refine", lambda: ck.search(q, big, top_cells=COARSE_P)),
        variants={f"lanes_{g}_ms": (lambda k, g=g: coarse_knn.coarse_refine(ck, q, cells, lb, k, lanes=g))
                  for g in cuda_knn.GRID_LANES})
    return rows


def window_valid_pairs(ok_s: torch.Tensor, window: int) -> int:
    n, pairs = ok_s.shape[0], 0
    for o in list(range(-window, 0)) + list(range(1, window + 1)):
        lo, hi = max(0, -o), min(n, n - o)
        pairs += int((ok_s[lo:hi] & ok_s[lo + o:hi + o]).sum())
    return pairs


def shadow_scene(k: int, dev):
    """scripts/window_scenes.py's shadowing scene at k on the card: points in
    cells of 1e19 m, nearly all valid, so that most window distances overflow
    to +inf, each pass's padding (3e38) reaches its top k, and a pass-1
    padding entry (the index of the clipped partner at sorted position 0 or
    N - 1) shadows the same index in pass 2; (points, mask, window)."""
    pts, mask, window = window_scenes.shadow_scene(k)
    return torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev), window


def window_first_sequence(pts, mask, k):
    """window_self_knn as the port first ran it on the card: each pass's codes in
    torch ops, a sort, the gathered copies and the first window design
    (morton_window_simple), then the union in torch ops."""
    rows = []
    for order in window_knn.AXES:
        perm = torch.sort(window_knn.morton_codes(pts, mask, 0.5, order), stable=True)[1]
        rows.append(window_knn.morton_window_simple(pts[perm].contiguous(), mask[perm].contiguous(),
                                                    perm.to(torch.int32), WINDOW_W, k))
    return window_knn.window_union_plain(*rows[0], *rows[1], k)


def check_window_passes(pts, mask, window: int, k: int, cell: float, what: str):
    """Every kernel of the Morton window against its plain version bit for
    bit: the codes of both passes, pass 1 and the union pass in the gather
    form, the sorted form and the first design on pass 1's sorted copies,
    and window_self_knn against the plain two passes; (pass 1, pass 2)."""
    codes = window_knn.morton_codes_passes(pts, mask, cell)
    if not torch.equal(codes, window_knn.morton_codes_passes_plain(pts, mask, cell)):
        raise AssertionError(f"morton_codes ({what}) differ from their plain version")
    order = torch.sort(codes, dim=1, stable=True)[1]
    p1 = window_knn.window_gather(pts, mask, order[0], window, k)
    r1 = window_knn.window_gather_plain(pts, mask, order[0], window, k)
    check_equal("morton_window", p1, r1, f"{what}, pass 1 (gathered through the sort), k={k}")
    p2 = window_knn.window_gather(pts, mask, order[1], window, k)
    check_equal("morton_window", p2, window_knn.window_gather_plain(pts, mask, order[1], window, k),
                f"{what}, pass 2, k={k}")
    check_equal("morton_window_union", window_knn.window_gather(pts, mask, order[1], window, k, prev=p1),
                window_knn.window_gather_plain(pts, mask, order[1], window, k, prev=r1), f"{what}, k={k}")
    args = (pts[order[0]].contiguous(), mask[order[0]].contiguous(), order[0].to(torch.int32), window, k)
    ref = window_knn.window_search_plain(*args)
    check_equal("morton_window", window_knn.window_search(*args), ref, f"{what}, sorted copies, k={k}")
    check_equal("morton_window_simple", window_knn.morton_window_simple(*args), ref, f"{what}, k={k}")
    got = window_knn.window_self_knn(pts, mask, k, window=window, cell_size=cell)
    plain = window_knn.window_self_knn_plain(pts, mask, k, window, cell)
    check_equal("window_self_knn", (got.indices, got.distances), (plain.indices, plain.distances),
                f"{what}, against the plain two passes, k={k}")
    torch.cuda.synchronize()
    return p1, p2


def check_window_kernel(lo_out, dev) -> list:
    """The Morton window (csrc/window_knn.cu) on one 2048 x 64 scan (k=10,
    W=64, two passes): window_self_knn driven with the counts at 0 (its
    launches: morton_min, morton_codes, morton_window, morton_window_union),
    its device launches under the profiler beside the first sequence, its
    recall against the exact knn_k; every kernel bit for bit against its
    plain version at k = 10, 32, 64 and 128 (an all-masked scan and the
    shadowing scenes too); timed in turns: each kernel with its plain
    version (and the pass with its first design, morton_window_simple),
    window_self_knn with the first sequence, the plain two passes and knn_k;
    the sort of both passes' codes in one call and in two."""
    _, _, scans, _ = lo_out["replay"]
    pts, mask = scans[-1].points.contiguous(), scans[-1].mask.contiguous()
    N, valid, cell = pts.shape[0], int(mask.sum()), 0.5
    torch.cuda.synchronize()
    cuda_knn.reset_launch_counts()
    res = window_knn.window_self_knn(pts, mask, K, window=WINDOW_W)
    torch.cuda.synchronize()
    launches = dict(cuda_knn.launch_counts)
    path_kernels = ("morton_min", "morton_codes", "morton_window", "morton_window_union")
    if any(launches[n] != 1 for n in path_kernels) or sum(launches.values()) != len(path_kernels):
        raise AssertionError(f"window_self_knn launched {launches}, not one of each of {path_kernels}")
    n_dev = device_launches(lambda: window_knn.window_self_knn(pts, mask, K, window=WINDOW_W))
    n_first = device_launches(lambda: window_first_sequence(pts, mask, K))
    exact = self_knn(pts, mask, K)
    rows = torch.nonzero(mask)[::13, 0]
    recall = float((res.indices[rows][:, :, None] == exact.indices[rows][:, None, :]).any(-1).float().mean())
    if recall <= 0.70:
        raise AssertionError(f"window_self_knn recall {recall:.4f} below the 0.70 envelope")
    for k in (K, *cuda_knn.LARGE_K):
        check_window_passes(pts, mask, WINDOW_W, k, cell, "the scan")
        check_window_passes(pts, torch.zeros_like(mask), WINDOW_W, k, cell, "all masked")
    n_shadowed = {}
    for k in window_scenes.SHADOW:
        sp, sm, sw = shadow_scene(k, dev)
        p1, p2 = check_window_passes(sp, sm, sw, k, window_scenes.SHADOW_CELL, f"the shadowing scene, k={k}")
        n_shadowed[k] = window_scenes.shadowed(*p1, *p2)
        if not n_shadowed[k]:
            raise AssertionError(f"the shadowing scene at k={k} holds no shadowed entry")

    codes = window_knn.morton_codes_passes(pts, mask, cell)
    order = torch.sort(codes, dim=1, stable=True)[1]
    args = (pts[order[0]].contiguous(), mask[order[0]].contiguous(), order[0].to(torch.int32), WINDOW_W, K)
    p1 = window_knn.window_gather(pts, mask, order[0], WINDOW_W, K)
    r1 = window_knn.window_gather_plain(pts, mask, order[0], WINDOW_W, K)
    cmin = torch.empty(3, dtype=torch.int32, device=dev)
    lib, stream = cuda_knn.load_library(), lambda: torch.cuda.current_stream(dev).cuda_stream
    out = torch.empty_like(codes)
    pack = sum((o[0] | o[1] << 2 | o[2] << 4) << (6 * p) for p, o in enumerate(window_knn.AXES))
    min_call = lambda: lib.spt_morton_min(pts.data_ptr(), mask.data_ptr(), N, 1.0 / cell, cmin.data_ptr(), stream())
    codes_call = lambda: lib.spt_morton_codes(pts.data_ptr(), mask.data_ptr(), N, 1.0 / cell, cmin.data_ptr(), pack, 2,
                                              out.data_ptr(), stream())
    min_call()
    prep = cuda_knn.prep_target(pts, mask)
    t = in_turns({"pass_plain_ms": lambda: window_knn.window_gather_plain(pts, mask, order[0], WINDOW_W, K),
                  "pass_ms": lambda: window_knn.window_gather(pts, mask, order[0], WINDOW_W, K),
                  "sorted_ms": lambda: window_knn.window_search(*args),
                  "simple_ms": lambda: window_knn.morton_window_simple(*args),
                  "union_ms": lambda: window_knn.window_gather(pts, mask, order[1], WINDOW_W, K, prev=p1),
                  "union_plain_ms": lambda: window_knn.window_gather_plain(pts, mask, order[1], WINDOW_W, K, prev=r1),
                  "min_ms": min_call, "codes_ms": codes_call,
                  "codes_plain_ms": lambda: window_knn.morton_codes_passes_plain(pts, mask, cell),
                  "sort_one_ms": lambda: torch.sort(codes, dim=1, stable=True),
                  "sort_two_ms": lambda: (torch.sort(codes[0], stable=True), torch.sort(codes[1], stable=True)),
                  "window_self_knn_ms": lambda: window_knn.window_self_knn(pts, mask, K, window=WINDOW_W),
                  "first_sequence_ms": lambda: window_first_sequence(pts, mask, K),
                  "plain_two_passes_ms": lambda: window_knn.window_self_knn_plain(pts, mask, K, WINDOW_W, cell),
                  "knn_k_ms": lambda: cuda_knn.knn_k_prepped(prep, pts, K)})
    pairs = window_valid_pairs(args[1], WINDOW_W)
    b_pass = bound(pairs, 13 * N + 8 * N + 8 * N * K)  # the cloud, its mask and the order in; the rows out
    b_union = bound(pairs, 13 * N + 8 * N + 16 * N * K)  # and pass 1's rows in
    b_min, b_codes = bound(0, 13 * N + 12), bound(0, 13 * N + 12 + 8 * N)
    b_call = bound(2 * pairs, 2 * (13 * N + 8 * N) + 8 * N * K)  # the codes written / sorted aside
    print(f"morton_window (one 2048 x 64 scan: N={N}, valid {valid}, k={K}, W={WINDOW_W}, two passes, {pairs} valid "
          f"window pairs a pass): window_self_knn launched {launches} ({n_dev} device launches under the profiler, "
          f"the first sequence {n_first}); recall {recall:.4f} against the exact knn_k (every 13th valid row); every "
          f"kernel equal to its plain version bit for bit at k = {(K, *cuda_knn.LARGE_K)} (all masked too) and on the "
          f"shadowing scenes (shadowed entries {n_shadowed}); marginal CUDA-event ms, medians in turns: "
          + ", ".join(f"{n} {v:.4f}" for n, v in t.items())
          + f"; bounds: pass {b_pass[0]:.6f} ({b_pass[1]}), union pass {b_union[0]:.6f} ({b_union[1]}), "
          f"morton_min {b_min[0]:.6f} ({b_min[1]}), morton_codes {b_codes[0]:.6f}, window_self_knn "
          f"{b_call[0]:.6f} ({b_call[1]}); "
          f"window_self_knn / the first sequence {t['window_self_knn_ms'] / t['first_sequence_ms']:.4f}, pass / first "
          f"design {t['pass_ms'] / t['simple_ms']:.4f}; sort of both passes: one call {t['sort_one_ms']:.4f}, two "
          f"{t['sort_two_ms']:.4f} (window_self_knn sorts in one); no library call computes these")
    shapes = {"2048 x 64 scan": {"N": N, "valid": valid, "k": K, "window": WINDOW_W, "pairs": pairs, "recall": recall,
                                 "device_launches": n_dev, "first_sequence_device_launches": n_first, **t}}
    none = {"library": "none computes it"}
    out_rows = [
        row("morton_window", WINDOW_SOURCE, WINDOW_REPLACES, WINDOW_PATH, 0.0, (t["pass_ms"], t["pass_plain_ms"], None),
            b_pass, launches=launches["morton_window"], previous_ms=t["simple_ms"], sorted_ms=t["sorted_ms"],
            shapes=shapes, **none),
        row("morton_window_union", WINDOW_SOURCE, WINDOW_UNION_REPLACES, WINDOW_PATH, 0.0,
            (t["union_ms"], t["union_plain_ms"], None), b_union, launches=launches["morton_window_union"], **none),
        row("morton_min", WINDOW_SOURCE, WINDOW_CODES_REPLACES, WINDOW_PATH, 0.0,
            (t["min_ms"], t["codes_plain_ms"], None), b_min, launches=launches["morton_min"], **none),
        row("morton_codes", WINDOW_SOURCE, WINDOW_CODES_REPLACES, WINDOW_PATH, 0.0,
            (t["codes_ms"], t["codes_plain_ms"], None), b_codes, launches=launches["morton_codes"], **none),
        row("morton_window_simple", WINDOW_SOURCE, WINDOW_REPLACES, "timing only (the first design)", 0.0,
            (t["simple_ms"], t["pass_plain_ms"], None), b_pass, launches=launches["morton_window_simple"], **none),
    ]
    # the instances above 16 on the same pass (2 W = 128 candidates)
    first = {k: window_knn.window_gather(pts, mask, order[0], WINDOW_W, k) for k in cuda_knn.LARGE_K}
    out_rows += instance_rows(
        "morton_window", WINDOW_SOURCE, WINDOW_REPLACES, WINDOW_PATH, cuda_knn.LARGE_K,
        lambda k: window_knn.window_gather(pts, mask, order[0], WINDOW_W, k),
        lambda k, got: check_equal("morton_window", got,
                                   window_knn.window_gather_plain(pts, mask, order[0], WINDOW_W, k), f"pass 1, k={k}"),
        lambda k: window_knn.window_gather_plain(pts, mask, order[0], WINDOW_W, k),
        lambda k: bound(pairs, 13 * N + 8 * N + 8 * N * k),
        lambda big: driven("morton_window", lambda: window_knn.window_self_knn(pts, mask, big, window=WINDOW_W)),
        variants={"simple_ms": lambda k: window_knn.morton_window_simple(*args[:4], k),
                  "union_ms": lambda k: window_knn.window_gather(pts, mask, order[1], WINDOW_W, k, prev=first[k]),
                  "window_self_knn_ms": lambda k: window_knn.window_self_knn(pts, mask, k, window=WINDOW_W),
                  "first_sequence_ms": lambda k: window_first_sequence(pts, mask, k)})
    return out_rows


# -Xptxas -v of the sources redesigned above k = 16 and of the study kernels'
# ring: every instance of these kernels must report 0 spill bytes; the
# one-thread instances (knn_cluster_kernel at K = 32 / 64 / 128, kept as
# knn_k_spill, range_image_tile_kernel at K = 32 / 64 / 128, kept as
# range_image_window_spill, and the first Morton window design) are printed
# beside them
SPILL_SOURCES = ("window_knn.cu", "knn_cluster.cu", "range_image.cu", "nn1_tiles.cu", "nn1_variants.cu")
NO_SPILL_KERNELS = ("knn_warp_kernel", "morton_warp_kernel", "morton_tile_kernel", "morton_codes_kernel",
                    "morton_min_kernel", "range_image_warp_kernel", "nn1_ring_kernel")


def start_spill_report():
    """nvcc -Xptxas -v of SPILL_SOURCES, one process a source, started in the
    background (its build is not the library's)."""
    work = tempfile.mkdtemp()
    procs = [(src, subprocess.Popen([cuda_knn.find_nvcc(), *cuda_knn.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                                     os.path.join(work, src + ".o"), os.path.join(cuda_knn.CSRC_DIR, src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
             for src in SPILL_SOURCES]
    return procs, work


def spill_report(started) -> dict:
    """Registers and spill bytes of every instance of the redesigned kernels
    and of the one-thread large instances; fails if a redesigned one spills."""
    procs, work = started
    out = {}
    for src, proc in procs:
        text = proc.communicate()[0]
        if proc.returncode:
            raise AssertionError(f"nvcc -Xptxas -v {src} failed:\n{text[-4000:]}")
        lines = text.splitlines()
        for i, line in enumerate(lines):
            m = re.search(r"Function properties for (\S+)", line)
            spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                              lines[i + 1]) if m and i + 1 < len(lines) else None
            if spill:
                regs = next((re.search(r"Used (\d+) registers", l) for l in lines[i + 2:i + 4]
                             if "Used" in l), None)
                out[m.group(1)] = {"stack": int(spill.group(1)), "spill_stores": int(spill.group(2)),
                                   "spill_loads": int(spill.group(3)),
                                   "registers": int(regs.group(1)) if regs else None}
    shutil.rmtree(work, ignore_errors=True)
    names = list(out)
    filt = shutil.which("c++filt")
    plain = subprocess.run([filt], input="\n".join(names), capture_output=True, text=True).stdout.splitlines() \
        if filt else names
    report = {}
    for mangled, name in zip(names, plain):
        short = re.sub(r"\(.*", "", name.replace("(anonymous namespace)::", "")).replace("void ", "")
        kernel = next((k for k in NO_SPILL_KERNELS if k in short), None)
        old = ("knn_cluster_kernel" in short or "morton_window_kernel" in short or
               "range_image_tile_kernel" in short) and \
            any(f"<{K}" in short for K in cuda_knn.LARGE_K)
        if kernel or old:
            report[short] = out[mangled]
    redesigned = {n: r for n, r in report.items() if any(k in n for k in NO_SPILL_KERNELS)}
    bad = {n: r for n, r in redesigned.items() if r["spill_stores"] or r["spill_loads"]}
    line = lambda n, r: f"{n} {r['registers']} registers, {r['spill_stores']} / {r['spill_loads']} B spilled"
    print(f"-Xptxas -v: {len(redesigned)} instances of {', '.join(NO_SPILL_KERNELS)}: "
          f"{sum(r['spill_stores'] for r in redesigned.values())} bytes of spill stores, at most "
          f"{max(r['registers'] or 0 for r in redesigned.values())} registers; "
          + "; ".join(line(n, r) for n, r in sorted(redesigned.items()) if "warp" in n or "ring" in n)
          + "; the one-thread instances: "
          + "; ".join(line(n, r) for n, r in sorted(report.items()) if n not in redesigned))
    if bad:
        raise AssertionError(f"redesigned kernel instances spill: {bad}")
    return report


def pair_preprocess_phase(src_raw, tgt_raw, cap) -> None:
    """preprocess_pair against two sequential preprocesses of the pair's
    scans: the same voxels, covariances and normals bit for bit, and ms of
    each in turns."""
    a = PointCloud(points=src_raw.points, mask=src_raw.mask)
    b = PointCloud(points=tgt_raw.points, mask=tgt_raw.mask)

    def sequential():
        out = []
        for c in (a, b):
            d = voxel_downsample(c, VOXEL, out_capacity=cap)
            covs = estimate_covariances(d.points, self_knn(d.points, d.mask, K))
            out.append(d.replace(covs=covs, normals=extract_normals(d.points, covs)))
        return out

    fused = preprocess_pair(a, b, VOXEL, cap, K)
    for f, s, name in zip(fused, sequential(), ("source", "target")):
        m = s.mask
        same = torch.equal(f.mask, m) and all(torch.equal(getattr(f, x)[m], getattr(s, x)[m])
                                              for x in ("points", "covs", "normals"))
        if not same:
            raise AssertionError(f"preprocess_pair's {name} differs from the sequential preprocess")
    t = in_turns({"sequential_ms": sequential, "preprocess_pair_ms": lambda: preprocess_pair(a, b, VOXEL, cap, K)})
    print(f"preprocess_pair (the scan pair, {VOXEL} m voxels, capacity {cap}, k={K}): voxels, covariances and normals "
          f"equal to two sequential preprocesses bit for bit; {t['preprocess_pair_ms']:.4f} ms against "
          f"{t['sequential_ms']:.4f} ms sequential (marginal CUDA-event ms, medians in turns)")


def sharded_phase(source, target) -> None:
    """sharded_align on the card's one-device mesh equal to align bit for
    bit; on a two-entry mesh of the card (two shards, the per-shard moves,
    the partial sums) within SHARDED_T_TOL of align on T with equal inliers;
    device_info."""
    mesh = sharded.make_mesh()
    params = RegistrationParams(max_iterations=10)
    got = sharded.sharded_align(mesh, source, target, params)
    ref = align(source, target, BruteForceKNN.build(target), params)
    torch.cuda.synchronize()
    for name, a, b in zip(ref._fields, got, ref):
        if not (a == b if isinstance(a, int) else torch.equal(a, b)):
            raise AssertionError(f"sharded_align on {mesh} differs from align in {name}")
    two = mesh * 2
    got2 = sharded.sharded_align(two, source, target, params)
    torch.cuda.synchronize()
    t_gap = float((got2.T - ref.T).abs().max())
    print(f"sharded_align on the mesh {mesh}: equal to align bit for bit ({int(got.iterations)} iterations, "
          f"{int(got.inlier)} inliers); on {two}: T within {t_gap:.3g} of align, {int(got2.iterations)} iterations, "
          f"{int(got2.inlier)} inliers; device_info {device_info()}")
    if not (t_gap <= SHARDED_T_TOL and int(got2.inlier) == int(ref.inlier)):
        raise AssertionError(f"sharded_align on {two}: T gap {t_gap}, inliers {int(got2.inlier)} against "
                             f"{int(ref.inlier)}")


def gil_during_reads(dev) -> dict:
    """Spins a second of a Python thread while the main thread blocks in a
    read of ~100 ms of device work, over its spins a second alone (the main
    thread asleep): near 1 when the read lets go of the GIL, near 0 when it
    holds it."""
    a = torch.randn(4096, 4096, device=dev) / 64.0

    def busy():
        x = a
        for _ in range(30):
            x = torch.tanh(x @ a)
        return x.sum()

    def spins_while(wait) -> float:
        stop, spins = threading.Event(), [0]

        def spin():
            while not stop.is_set():
                spins[0] += 1

        torch.cuda.synchronize()
        t = threading.Thread(target=spin)
        t.start()
        t0 = time.perf_counter()
        wait()
        dt = time.perf_counter() - t0
        stop.set()
        t.join()
        return spins[0] / dt

    alone = spins_while(lambda: time.sleep(0.1))
    return {name: spins_while(read) / alone for name, read in (
        ("sync.to_host", lambda: sync.to_host(busy())),
        ("DeferredFetch.get", lambda: sync.DeferredFetch(busy()).get()))}


def shard_counts_per_frame(fleet, warm: int) -> list:
    """Each shard's host reads by source and launches a fleet frame after
    the warm-up."""
    rows = fleet.shard_counts[warm:]
    out = []
    for i in range(len(fleet.mesh)):
        reads, launches = {}, {}
        for r in rows:
            for src, k in r[i]["reads"].items():
                reads[src] = reads.get(src, 0) + k / len(rows)
            for name, k in r[i]["launches"].items():
                launches[name] = launches.get(name, 0) + k / len(rows)
        out.append((reads, launches))
    return out


def sharded_gap(a_poses, b_poses) -> tuple[float, float]:
    """The largest translation (m) and rotation (deg) gap of any stream's
    pose in any frame between two runs."""
    gaps = [stream0_gap(a, b) for a, b in zip(a_poses, b_poses, strict=True)]
    return max(g[0] for g in gaps), max(g[1] for g in gaps)


def sharded_turns(tag: str, run, mesh, warm: int, n_frames: int, ate_bounds) -> dict:
    """The unsharded fleet and the fleet on ``mesh`` in turns
    (SHARDED_TURNS), the counts at 0 before each run; the checks against
    the first unsharded run. Returns the last sharded run's output and
    launches."""
    outs, ms = {"unsharded": [], "two shards": []}, {"unsharded": [], "two shards": []}
    for which in SHARDED_TURNS:
        torch.cuda.synchronize()
        sync.reset_sync_count()
        cuda_knn.reset_launch_counts()
        out = run(None if which == "unsharded" else mesh)
        torch.cuda.synchronize()
        out["launches"] = Counter(cuda_knn.launch_counts)
        if min(out["launches"]["nn1_batched"], out["launches"]["knn_k_batched"]) <= 0:
            raise AssertionError(f"a kernel of the {tag}, {which}, never launched: {dict(out['launches'])}")
        outs[which].append(out)
        ms[which] += [r["ms"] for r in out["rows"][warm:]]
    B = outs["unsharded"][0]["fleet"].B
    for which, frame_ms in ms.items():
        print_fleet_timing(f"{tag}, {which} (both runs)", frame_ms, B)
    base = outs["unsharded"][0]
    print(f"{tag}: the unsharded runs' poses apart by at most "
          f"{max(sharded_gap(o['poses'], base['poses'])[0] for o in outs['unsharded']):.3g} m")
    for k, out in enumerate(outs["two shards"]):
        fleet = out["fleet"]
        if not isinstance(fleet, (ShardedFleetOdometry, ShardedFleetLIO)) or fleet.mesh != mesh:
            raise AssertionError(f"{tag}: mesh={mesh} made {type(fleet).__name__} on {fleet.mesh}")
        gap_m, gap_deg = sharded_gap(out["poses"], base["poses"])
        ates = print_fleet_results(f"{tag}, two shards, run {k}", out, n_frames)
        per_shard = shard_counts_per_frame(fleet, warm)
        reads, bl = per_fleet_frame(out["rows"][warm:])
        print(f"{tag}, two shards, run {k}: every pose within {gap_m * 1e3:.4f} mm and {gap_deg:.5f} deg of the "
              f"unsharded fleet's (bounds {SHARDED_M * 1e3:.0f} mm, {SHARDED_DEG} deg); ATE mean "
              f"{statistics.mean(ates):.4f} m (unsharded {statistics.mean(base['ates']):.4f}); growth events "
              f"{fleet.growth_events} (unsharded {base['fleet'].growth_events}); host reads a fleet frame "
              f"{sum(reads.values()):.2f}, batched launches a fleet frame "
              + ", ".join(f"{n} {v:.2f}" for n, v in sorted(bl.items())) + "; the last frame's stages (added "
              "over the shards; unsharded in brackets) "
              + ", ".join(f"{k} {v * 1e3:.2f} [{base['fleet'].processing_times.get(k, 0.0) * 1e3:.2f}] ms"
                          for k, v in sorted(fleet.processing_times.items())))
        for i, (r, lc) in enumerate(per_shard):
            print(f"{tag}, two shards, run {k}, shard {i} ({fleet.mesh[i]}, streams {fleet._rows[i].start}.."
                  f"{fleet._rows[i].stop - 1}): host reads a fleet frame {sum(r.values()):.2f}: "
                  + ", ".join(f"{src} {v:.2f}" for src, v in sorted(r.items(), key=lambda kv: -kv[1]))
                  + "; launches a fleet frame " + ", ".join(f"{n} {v:.2f}" for n, v in sorted(lc.items())))
        if gap_m > SHARDED_M or gap_deg > SHARDED_DEG:
            raise AssertionError(f"{tag}: two shards stray from the unsharded fleet ({gap_m} m, {gap_deg} deg)")
        if not statistics.mean(ates) <= ate_bounds[0] or not max(ates) <= ate_bounds[1]:
            raise AssertionError(f"{tag}: two shards' ATE {ates} above the bounds")
        if fleet.growth_events != base["fleet"].growth_events:
            raise AssertionError(f"{tag}: growth events differ from the unsharded fleet's")
    return outs["two shards"][-1]


def sharded_fleet_phase(dev, trajs, scans) -> list:
    """Phase 46: the fleet split over the card's mesh of one and of two
    entries, held to the unsharded fleet, and the batched kernels at a
    shard's shapes."""
    t_phase = time.perf_counter()
    gil = gil_during_reads(dev)
    print("a blocking read: another thread's spins a second while it waits, over its spins alone: "
          + ", ".join(f"{k} {v:.3f}" for k, v in gil.items()) + f" (fails under {SHARDED_GIL_MIN})")
    if min(gil.values()) < SHARDED_GIL_MIN:
        raise AssertionError(f"a blocking read holds the GIL: {gil}")

    B, n_frames, warm = fleet_replay.FLEET_STREAMS, fleet_replay.FLEET_FRAMES, fleet_replay.FLEET_WARMUP
    cap = pad_capacity_for(fleet_replay.FLEET_RAYS[0] * fleet_replay.FLEET_RAYS[1])
    params = fleet_replay.fleet_params()

    def run(mesh):
        kw = {} if mesh is None else {"mesh": mesh}
        return fleet_replay.run_fleet_replay(params, trajs, scans, device=dev, capacity=cap, **kw)

    plain, one = run(None), run([dev])
    torch.cuda.synchronize()
    gap = sharded_gap(one["poses"], plain["poses"])
    same = all(np.array_equal(a, b) for pa, pb in zip(one["poses"], plain["poses"]) for a, b in zip(pa, pb))
    print(f"sharded fleet on [{dev}]: every pose of every stream bit-equal to the unsharded fleet's: {same} "
          f"(largest gap {gap[0]:.3g} m, {gap[1]:.3g} deg); growth events {one['fleet'].growth_events}")
    if not same or one["fleet"].growth_events != plain["fleet"].growth_events:
        raise AssertionError(f"the fleet on the one-entry mesh [{dev}] differs from the unsharded fleet")

    two = [dev, dev]
    lo = sharded_turns("sharded fleet", run, two, warm, n_frames, (FLEET_MAX_MEAN_ATE_M, FLEET_MAX_ATE_M))

    lio_params = fleet_replay.fleet_lio_params()
    lio_scans = scans[:SHARDED_LIO_FRAMES]

    def run_lio(mesh):
        kw = {} if mesh is None else {"mesh": mesh}
        return fleet_replay.run_fleet_lio_replay(lio_params, trajs, lio_scans, device=dev, capacity=cap, **kw)

    lio = sharded_turns("sharded fleet LIO", run_lio, two, SHARDED_LIO_WARMUP, SHARDED_LIO_FRAMES,
                        (FLEET_LIO_MAX_MEAN_ATE_M, FLEET_LIO_MAX_ATE_M))
    print_lio_fleet_state("sharded fleet LIO", lio["fleet"])

    fleet = lo["fleet"]
    torch.cuda.synchronize()
    shard = fleet._shards[0]
    rows = check_fleet_kernels({**fleet_kernel_inputs(shard, scans[-1][: shard.B], cap, dev),
                                "launches": lo["launches"]}, SHARDED_FLEET_PATH, "sharded fleet's shard")
    print(f"sharded fleet phase: {time.perf_counter() - t_phase:.1f} s")
    return rows


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is False")
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = nvidia_smi("name,power.limit")
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"clocks.max.sm {sm_mhz:.0f} MHz x {n_sm} SMs x 128 FP32 lanes = "
          f"{n_sm * 128 * sm_mhz * 1e6:.4g} lane-ops/s (bounds use {FP32_OPS_PER_S:.4g})")

    t0 = time.perf_counter()
    cuda_knn.load_library()
    print(f"kernel build+load: {time.perf_counter() - t0:.2f} s")
    spills = start_spill_report()

    # --- data: a synthetic HDL-64 pair raycast on the card -----------------
    t0 = time.perf_counter()
    world = World()
    pose_tgt, pose_src = figure8_trajectory(2, speed=0.7)
    T_gt = np.linalg.inv(pose_tgt) @ pose_src
    src_np = scan_at(world, pose_src, device=dev)
    tgt_np = scan_at(world, pose_tgt, device=dev)
    src_raw = cloud_from_numpy(src_np, device=dev)
    tgt_raw = cloud_from_numpy(tgt_np, device=dev)
    cap = voxel_capacity((src_raw, tgt_raw), VOXEL)
    print(f"scan pair: {len(src_np)} / {len(tgt_np)} raw points, voxel capacity {cap}, "
          f"raycast+upload {time.perf_counter() - t0:.2f} s")

    # --- kernel phases at the main path's shapes ---------------------------
    src_vox = downsample(src_raw, VOXEL, cap)
    tgt_vox = downsample(tgt_raw, VOXEL, cap)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    queries = random_sampling(src_vox, N_QUERIES, gen).points.contiguous()
    pose = torch.as_tensor(T_gt, dtype=torch.float32, device=dev).contiguous()
    results = [check_nn1(tgt_vox, queries, pose), check_knn(tgt_vox)]
    check_small_pair_against_cpu(world, pose_src, pose_tgt, dev)
    check_pose_bit_exact(src_raw, tgt_raw, cap)
    results += check_study_kernels(tgt_vox, queries, pose)

    # --- the main path -------------------------------------------------------
    register_pair(src_raw, tgt_raw, VOXEL, K, cap, torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    cuda_knn.reset_launch_counts()
    res = register_pair(src_raw, tgt_raw, VOXEL, K, cap, torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    launches = dict(cuda_knn.launch_counts)
    print(f"main-path kernel launches: {launches}")
    for r in results:
        if r["path"] == "register_pair":
            r["launches"] = launches[r["name"]]
    if min(launches["nn1"], launches["knn_k"]) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")

    out = res.output.result
    check_on_device(out._asdict(), dev)
    for cloud in (res.source, res.target, res.output.registration_input):
        check_on_device(vars(cloud), dev)
    T = out.T.cpu().numpy().astype(np.float64)
    if T.shape != (4, 4) or not np.isfinite(T).all():
        raise AssertionError(f"bad pose {T}")
    trans_err, rot_err = pose_error(T, T_gt)
    print(f"voxels: source {int(res.source.count())}, target {int(res.target.count())}; "
          f"iterations {int(out.iterations)}, inliers {int(out.inlier)} of "
          f"{int(res.output.registration_input.count())}, error {float(out.error):.4f}")
    print(f"pose error vs ground truth: translation {trans_err * 100:.3f} cm, rotation {rot_err:.4f} deg "
          f"(ground-truth motion {np.linalg.norm(T_gt[:3, 3]):.3f} m)")
    if not (trans_err <= MAX_TRANS_ERR_M and rot_err <= MAX_ROT_ERR_DEG):
        raise AssertionError("registration error above 5 cm / 0.5 deg")

    # --- timing --------------------------------------------------------------
    pair_ms = []
    for i in range(6):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        register_pair(src_raw, tgt_raw, VOXEL, K, cap, gen)
        torch.cuda.synchronize()
        if i:  # the first run is a warm-up
            pair_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"register_pair: {statistics.median(pair_ms):.3f} ms per pair "
          f"(median of {len(pair_ms)}; runs {[round(t, 3) for t in pair_ms]})")
    for name, ms in stage_times(src_raw, tgt_raw, cap).items():
        print(f"stage {name}: {ms:.3f} ms (median of 5)")

    # --- the study entry points ------------------------------------------------
    run_studies(results)

    # --- the LiDAR-odometry frame ------------------------------------------------
    lo_out = lo_replay(dev)
    results += check_lo_shapes(lo_out)
    small_replays(dev)

    # --- the LiDAR-inertial frame -------------------------------------------------
    lio_out = lio_replay_phase(dev)
    results += check_lo_shapes(lio_out, LIO_PATH, "LIO")
    small_lio_replays(dev)

    # --- the odometry at the parameter tree's defaults ----------------------------
    og_out = og_replay(dev)
    results += check_lo_shapes(og_out, OG_PATH, "OG")
    og_small_replays(dev)

    # --- the serving path: pipelined frames, checkpoint, server, KITTI runner -------
    results += check_lo_shapes(pipelined_lo_phase(lo_out["replay"], dev, "LO"), LO_PIPE_PATH, "pipelined LO")
    results += check_lo_shapes(pipelined_lo_phase(og_out["replay"], dev, "OG"), OG_PIPE_PATH, "pipelined OG")
    stash_memory(og_out["replay"][0], dev)
    drop_retry_phase(dev)
    results += check_lo_shapes(pipelined_lio_phase(lio_out["replay"], dev), LIO_PIPE_PATH, "pipelined LIO")
    checkpoint_phase(og_out["replay"], dev)
    server_phase(lo_out["replay"], dev)
    kitti_phase(og_out["replay"], dev)

    # --- the fleet: the benchmark deployment, its kernels, the runner ---------------
    fleet_out = fleet_phase(dev)
    results += check_fleet_kernels(fleet_out)
    fleet_kitti_phase(dev)

    # --- the LIO fleet, and both fleets at the parameter tree's defaults ------------
    results += check_fleet_kernels(fleet_lio_phase(dev, fleet_out["trajs"], fleet_out["scans"]), FLEET_LIO_PATH,
                                   "fleet LIO")
    for f, path, tag in fleet_defaults_phase(dev):
        results += check_fleet_kernels(f, path, tag)

    # --- the registration options -----------------------------------------------------
    results += check_lo_shapes(c2f_replay_phase(dev), C2F_PATH, "C2F")
    c2f_card_vs_cpu(dev)
    options_lo_phase(lo_out["replay"], dev)
    options_lio_phase(lio_out["replay"], dev)
    options_fleet_lio_phase(dev, fleet_out["trajs"], fleet_out["scans"])
    intensity_sampling_phase(og_out["replay"], dev)

    # --- the raw range-image path and the rest of the API -----------------------------
    raw_out = raw_frames_phase(lo_out["replay"], og_out["replay"], lio_out["replay"], dev)
    box = lo_out["replay"][0].scan.preprocess.box_filter
    results += check_range_image(box_filter(lo_out["replay"][2][-1], box.min, box.max), lo_out["scan"],
                                 raw_out["kernel_launches"])
    raw_card_vs_cpu(dev)
    api_phase(raw_out, lo_out["replay"], dev)

    # --- item 12: GridKNN, CoarseKNN, the Morton window, the pair preprocess, the mesh -
    t0 = time.perf_counter()
    grid_out = grid_replay_phase(lo_out, dev)
    results += check_grid_kernel(lo_out, grid_out, dev)
    results += check_coarse_kernel(lo_out, dev)
    results += check_window_kernel(lo_out, dev)
    pair_preprocess_phase(src_raw, tgt_raw, cap)
    sharded_phase(res.source, res.target)
    print(f"item 12 phase: {time.perf_counter() - t0:.1f} s")

    # --- k above 16: the LO frame at neighbor_num 20, the K = 32, 64, 128 instances -----
    t0 = time.perf_counter()
    results += check_large_k(lo_out, large_k_frames(lo_out, dev), dev)
    print(f"k above 16 phase: {time.perf_counter() - t0:.1f} s")
    spill_report(spills)

    # --- the fleet split over a mesh of the card ------------------------------------------
    results += sharded_fleet_phase(dev, fleet_out["trajs"], fleet_out["scans"])

    print(f"smoke run: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": results}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
