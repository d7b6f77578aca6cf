#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (zrenderer_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--phases 4h,5h,6h]

With no argument every phase runs.  ``--phases`` takes comma-separated
prefixes of phase names: phases 1 and 2 run, then only the phases whose
names start with one of them (a phase that needs a skipped phase's result
fails), a line names the skipped phases, and the kernels line lists only
the kernels the phases reached.  Phases, in order, each printing its own
lines and seconds:

1. environment: torch/CUDA/nvcc versions, the card's name and power limit;
2. build: the CUDA kernels from ``zrenderer_tpu_torch/csrc``;
3. K1 (small-scene binned raster) against its plain torch version on the
   card, bit-exact: the test scene at 1080p, a triangle soup with clipped
   fan rows, exact depth ties between duplicated triangles, a wide soup at
   1920x1080 drawing into the padding rows 1080-1087 of the 1920x1088
   target (their pixel count printed, 0 fails) and a 1000-triangle soup
   whose one tile's list holds over 900 rows (K1's staging in many
   chunks);
4. K3 (hierarchy raster) against its plain version, bit-exact: the
   20K-triangle lattice at 1080p and the soup;
4k. ``hier_cases`` for K3, K3b, K5 and K5g (the keyed body over the
    hierarchy): every plane bit-exact against the plain version at
    HIER_ITEMS and at 64 work items a tile, the two equal (exact ties split
    across items, a row at z == 1.0 left clear, a subnormal and a NaN z,
    -0.0 ties both ways, whole tiles, the clipped soup, an empty scene);
    K3b's cases at 1088 rows with its bands at rows 0 and 544, laid side
    by side equal to K3's frame; K5g's on lit rows in all 13 planes, with
    its epilogue where a row passed with den < 0 (-0.0 where K3g's writes
    +0.0); K5's and K5g's also a soup spread over 300 superblocks
    (1 228 800 rows);
4b. K4 (record streaming), K4c (with the coarse class), K5 (streamed
    hierarchy) and K6 (global pair lists) against their plain versions,
    bit-exact: the 40K lattice at 1080p (above the 32768-row bound; K6 on
    the 20K lattice), the clipped soup, the duplicated soup (every exact
    depth tie to the first-submitted row) and the soup under small
    cap/budgets so that the budget clamp and the coarse phase engage;
    the plain K5's time at 40K and K6's at 20K are their plain_ms; then
    K4's and K4c's keyed body (``keyed_cases``; K4c with cap 1, so that
    every row over more than one tile is a coarse record), every row
    bit-exact at the default work-item size and at 16 records: a soup
    packed into one 128x32 tile (a span of over 100 items), the duplicated
    soup (exact ties split across items), a row at z == 1.0 (one pixel
    latched), -0.0 ties both ways, a triangle over whole 1024x512 tiles,
    the clipped soup and an empty scene; K4c also a 6000-triangle soup in
    one 512x128 coarse bin, every tile cut into several items at the
    default size;
4g. the G-buffer kernels K2g (small-scene lists), K3g (hierarchy), K4g
    (record streaming) and K5g (streamed hierarchy) against their plain
    versions, all 13 planes bitwise as int32 (so -0.0 and NaN count): K2g
    on the test scene at 1080p, K3g on the 20K lattice, K4g and K5g on the
    40K lattice, each on the clipped soup and the duplicated soup (exact
    ties), each with random normal matrices and a random material table
    (one row per triangle, so a wrong winner shows in the constant
    planes); the plain K2g, K3g and K5g calls give their plain_ms; then
    ``keyed_cases`` for K4g on lit rows, all 13 planes bitwise at the
    default work-item size and at 16 records, and ``hier_cases`` for K3g
    on lit rows at HIER_ITEMS and at 64 work items a tile (exact ties
    split across items, a row at z == 1.0 left clear, a subnormal and a
    NaN z, -0.0 ties both ways, whole tiles, the clipped soup, an empty
    scene);
4d. the depth-only kernels of the shadow-map pass, K2d (small-scene
    lists), K3d (hierarchy), K4d (record streaming) and K6d (global pair
    lists), and K6g (the G-buffer over global pair lists) against their
    plain versions, bitwise as int32: K2d on the test scene, K3d and K6d on
    the 20K lattice, K4d on the 40K lattice, each from the light's view
    into the 1024x1024 map; K6g on the 20K lattice at 1080p with a random
    material table; each on the clipped soup, the duplicated soup and a
    wide soup with rows whose bbox clamps to empty at the map's bottom and
    right edges and past them, the depth planes of all four equal by
    value; the plain K2d, K3d, K6d and K6g calls give their plain_ms; K2d
    also on a one-tile list of over 900 rows; then ``keyed_cases`` for
    K4d, for K6d (K4d's keyed body over row-id
    spans; no pixel latched at z == 1.0, the first visited row's zero sign
    kept), for K6 (K4's over them; one pixel latched) and for K6g (K4g's
    over them, on lit rows, all 13 planes) and ``hier_cases`` for K3d;
4l. the tiled light kernel K7 against its plain version, the 3 output
    planes bitwise as int32, f32 and bf16 planes: the 1080p deferred
    G-buffer of the test scene (padded to 1920x1088) with BASELINE config
    3's 256 "wide" and "r2" lights, random planes with lights behind the
    camera, random planes with tiles that list no light, and a band at
    rows 544-799 of a 1088-row frame (``row_offset``), and 1500 wide
    lights on random planes (the light list staged in two chunks); the
    work-item cut on random planes with the wide lights under five masks:
    one covered pixel in a tile, a checkerboard, every pixel, none (K7
    writes zeros), and tiles of exactly ITEM_PIXELS, ITEM_PIXELS + 1 and
    2 ITEM_PIXELS + 1 covered pixels; the plain calls on the test scene
    give K7's plain_ms;
4o. the overlay kernels, K8 (layered raster) and K8b (atlas composite),
    against their plain versions: K8's count, overflow and 3K layer planes
    bitwise as int32, then K8b's u8 frame on K8's planes and a random
    frame: the OverlayUI (--overlay) and ImguiOverlay (--ui) draw lists of
    the test scene at 1080p (the --ui calls give both plain_ms), the
    reference test's busy draw list scaled to 1080p, a random soup of 4096
    translucent triangles with scissors (some pixels deeper than K), the
    overflow stack for K = 8 and 2, a 1000x517 frame, a 127x33 frame (K8b's
    scalar tail: 4191 pixels) and the 1080p frame with no live layer (K8b's
    copy path: the frame with alpha 255); then K8b on a 1000x517 frame
    view at a 4-byte offset into a larger buffer, alone and with the count
    such a view too (the wrapper copies a view off a 16-byte boundary
    before the launch), bit-exact against the plain version and the
    kernel on a copy;
5. the main path: ``Renderer.render_and_read`` at 1080p on the test scene
   (K1) and the lattice (K3), with the launch counts of that run, and the
   256x144 frame against the NumPy oracle (the port's geometry on CPU
   tensors, then the oracle's scalar loop);
5b. the large-scene paths, each driven with every launch count set to 0
    just before and read just after: the 1M-triangle lattice at 1080p
    through ``auto`` (K4) and ``hierarchy`` (K5), the visible frames
    bit-equal; a 1M soup through ``tile_lists`` (K4c), bit-equal to
    ``auto`` (K4 without the coarse class); the 20K lattice through
    ``tile_lists`` (K6); with each frame's pair count, longest and mean
    span, peak memory and coverage.  K4 on the 1M lattice and K4c on the
    1M soup (coarse class non-empty) are held bit-exact against their
    plain versions on those main-path inputs, which time plain_ms (K4c
    also at 16 records an item, equal to its default), and K4's pixels in
    the padding rows 1080-1087 are counted;
5l. the lit main path, ``Renderer(pipeline="lit")`` at 1080p, each run
    with every launch count set to 0 just before and read just after: the
    test scene with the 256x256 checker pattern (K2g, one launch a frame),
    held against the port's CPU lit frame (coverage exact, u8 within 2
    LSB); the showcase scene with its texture array; the 20K lattice (K3g);
    the 1M lattice through ``auto`` (K4g) and ``hierarchy`` (K5g), whose
    visible G-buffer planes are bitwise equal (K4g is held bit-exact
    against its plain version on those main-path inputs, which time its
    plain_ms); and the 160x96 lit frame of
    the procedural test scene against ``tests/goldens/lit_160x96.png``
    within 2 LSB;
5s. the shadowed main path, ``Renderer(pipeline="shadowed")`` at 1080p
    with a 1024x1024 shadow map, each run with every launch count set to 0
    just before and read just after: the test scene (K2d and K2g, one
    launch each), held against the port's CPU frame (coverage exact, the
    shadow map bit-equal, the PCF lit fraction equal but on a stated share
    of pixels where whole taps flip, u8 within 2 LSB elsewhere); the 20K
    lattice through ``auto`` (K3d, K3g) and ``tile_lists`` (K6d, K6g),
    equal shadow maps and frames; the 1M lattice through ``auto`` (K4d,
    K4g) and ``hierarchy`` (K5's depth plane, K5g), equal shadow maps and
    frames, K4d held bit-exact against its plain version on those inputs,
    which time its plain_ms; and the 160x96 frame against
    ``tests/goldens/shadowed_160x96.png``;
5dl. the deferred main path, ``Renderer(pipeline="deferred")`` at 1080p on
    the test scene with the wide and the r2 lights (K2g and K7, one launch
    each a frame) and with bf16 planes (K2g and K7's bf16 instantiation),
    each run with every launch count set to 0 just before and read just
    after; both light sets held against the port's CPU frame at 480x270
    (coverage exact, u8 within 2 LSB), and the 160x96 frame of the
    procedural test scene against ``tests/goldens/deferred_160x96.png``;
5t. TAA: ``taa_resolve`` and ``taa_resolve_packed`` on 8 jittered 1080p
    test-scene frames on the card, bit-equal to each other and to the
    CPU's; ``tests/goldens/taa_converged_160x96.png`` bit-equal through 8
    jittered flat frames; BASELINE config 4 on one card, the 1M lattice
    through K4 and ``taa_resolve_packed`` with the history carried over 8
    jittered frames, as ``benchmarks/config4.py`` composes them;
5o. the overlay main path: the 1080p test-scene frame (K1) through
    ``OverlayUI.compose`` and through ``ImguiOverlay.compose``, launch
    counts set to 0 just before and read just after (K1, K8 and K8b once a
    frame), each held against the port's CPU composite of the same frame
    (count and overflow exact, u8 within 1 LSB), and the 160x96 frame
    against ``tests/goldens/overlay_160x96.png`` within 1 LSB;
5a. assets: libzrt built (phase 2 runs g++ beside nvcc) and loaded; the
    showcase's ``showcase.gltf`` loaded at run time (its time printed,
    default and ``optimize=True``), the optimized load serializing to the
    committed bins; the lit (K2g), shadowed (K2d, K2g) and flat (K1)
    1080p frames from that load bit-equal to the bins' frames, with each
    lit and shadowed frame's time (CUDA events) and busy time (one traced
    frame); the default load's lit frame against its CPU frame (coverage
    equal, LIT_MAX_LSB); the two textures written as uncompressed DDS,
    BMP, TGA, PNM and TIFF, decoded through ``read_image`` (times
    printed) and bound through a copy of the glTF whose image uris name
    them, each lit frame bit-equal to the PNG-textured one; the quad, oct
    and pvar samplers on the card over a 1080p uv/lod/layer plane
    bit-equal to ``sample_trilinear``; the app off the .gltf, its frame
    equal to the default load's and textured (the four showcase frames'
    busy times come from phase 6a, which traces them after 7t, since no
    trace may come before the plain loops);
4s. the band kernels of the sharded frames against their plain versions,
    bit-exact (int32 bits), on rows gathered from triangle shards (the
    indexed geometry of every shard, then the canonical order): K3b on the
    test scene from 2 shards at 1920x1088 (bands at rows 0 and 544) and
    on the 20K lattice from 2 shards (32 512 rows; its plain call gives
    K3b's plain_ms); K3b above 32768 rows, the ``hierarchy`` band of the
    40K lattice from 2 shards at 1920x1088 (two groups of the keyed walk),
    both bands at HIER_ITEMS and 64 items a tile against the plain K3b
    (unless the 20K time, scaled by the rows, predicts over 60 s) and laid
    side by side against K5's frame; K9 (here at the default work-item
    size and at 16 records an item, the two equal) with band-local and
    global spans and K9g (13
    planes, random normals and per-triangle materials) on the 40K lattice
    from 4 shards at 1920x1024, every band; K9g on the deferred test
    scene from 2 shards at 1920x1088, both bands (the main path's shape;
    its plain_ms); K9 with both span forms on the 40K lattice from 2
    shards at 1920x1088, both bands (band 0 its plain_ms); K9d (at the
    default work-item size and at 16 records an item, the two equal, with
    the launch's blocks and the items they find) on a 2048-triangle
    clipped soup under a 16-record slab (256 after rounding), so that rows
    are demoted to the owner's hierarchy, with 2 and 4 sources (the script
    fails if none is), and on the 40K lattice from 2 shards (its
    plain_ms); the all-to-all is the in-turn exchange
    of ``parallel/tiles.py`` (``dist_exchange``), which stacks piece b of
    every shard's ``prepare_binned_dist_local``, the tensor the collective
    delivers;
5m. the sharded frames, one card rendering every band in turn
    (``parallel/tiles.py`` ``bands_in_turn``, ``deferred_bands_in_turn``,
    ``taa_bands_in_turn``: the frames' own stages with the in-turn
    exchange), each run with every launch count set to 0 just before and
    read just after (the kernels line reports the counts of one main-path
    frame: the test scene for K3b, the 1M lattice with 2 bands for K9, the
    40K lattice's ``dist`` frame for K9d, the deferred test scene with the
    wide lights for K9g); the bands laid side by side must equal
    the single-device frame at the same size, RGBA and depth bits: the
    flat test scene with 2 bands (K3b), the 1M lattice through ``auto``
    with 2 bands at 1920x1088 and 4 at 1920x1024 (K9, against K4), the 40K
    lattice through ``dist`` (K9d), the deferred test scene with the wide
    and the r2 lights (K9g + K7 per band, against the deferred Renderer),
    and config 4 with 2 bands (the 1M lattice over 8 jittered frames, the
    halo-row resolve, against K4 + ``taa_resolve_packed``); then
    ``make_sharded_frame``, ``_2d``, ``make_multihost_frame`` with
    ``dist``, ``_deferred`` and ``_taa`` once each under a real one-rank
    NCCL group, with ``gather_frame``;
4x. the raster experiments, K10g8/K10g8g/K10g8d (group-tile lists, then
    the leftover mega/super/block hierarchy) and K10vec/K10vecg
    (lane-parallel subgroups), against their plain versions, every plane
    bitwise as int32 (the sign of a zero z counts; on the keyed body, at
    their default work items a tile and again at one): K10g8 and
    K10vec on the 40K lattice at 1920x1088,
    K10g8g and K10vecg on the test scene and the 40K lattice (random
    normals and per-triangle materials), K10g8d on the 20K lattice's light
    view into the 1024x1024 map (each path's shape; those plain calls give
    plain_ms); every kernel on the clipped soup, the duplicated soup (each
    exact tie to the first-submitted row), the reference test's blow-up
    soup at 256x64 (group8's two phases each drawing alone, and a 32-row
    list budget leaving the frame unchanged), the edge soup in the map
    (rows clamped to an empty bbox past both edges; K10g8 and K10vec equal
    K5) and an empty scene; each case prints the rows each phase holds;
5x. the experiment entry points once each, launch counts set to 0 just
    before and read just after (one launch each): K10g8 and K10vec on the
    1M lattice at 1920x1088, the visible rows equal to K5's and K4's frames
    (RGBA and depth bits), the padding rows 1080-1087 clear where K5 and K4
    draw; then K10g8 and K10vec against their plain versions on one 1M
    prepare, all 1088 rows bitwise (the plain versions' seconds printed);
    K10g8g and K10vecg on the 1M lattice's lit rows, the 13 planes of
    rows 0-1079 equal to K5g's and rows 1080-1087 clear; K10g8d on the map
    against K3d;
4f. K1 and K4 at 3840x2176 (the SSAA 2 extent) against their plain
    versions, bitwise, on the rows phase 5f's supersample=2 frames give
    them: the test scene (K1) and the culled rows of a 196 608-triangle
    sphere field (K4; its budgets printed);
Phases 5e, 5f and 7t run after 5x and 4f and just before 6x: they take
the process's first profiler traces, and once a process has traced, some
1M further launches (the plain versions' loops of phases 3-5x and 4f)
cost a later trace its kernel records;
5e. the engine API at 1080p, each path driven with every launch count set
    to 0 just before and read just after: a vertex shader (x + 0.5, exact)
    on the test scene's flat (K1), lit (K2g), shadowed (K2d, K2g; the
    shadow pass runs no shader, as the reference's: its map equal to the
    unshaded frame's, the other renderer given the frustum of the bound
    buffers and that map) and deferred (K2g, K7) frames, each bit-equal to
    the same pipeline's frame of the scene whose vertices the host moved,
    and after
    ``set_vertex_shader(None)`` to the unshaded frame; the 1M lattice
    through the indexed entry (K4), an identity shader's frame bit-equal to
    the column path's, the shift shader's frame timed against the column
    path; the mesh pipeline, a 708 x 708-quad grid (1 002 528 triangles)
    generated on the card (K4), its generator and padding run under
    ``torch.cuda.set_sync_debug_mode("error")`` (no synchronisation) and
    timed, the dispatch's synchronisations counted, its frame bit-equal to
    the same buffers through ``load_scene``; ``generate_mip_chain`` of a
    2048^2 texture through ``create_compute_pipeline``/``dispatch`` equal to
    a direct call, a stale handle raising; a ``debug=True`` frame equal to
    the frame without it, a NaN depth raising ``FloatingPointError``;
5f. SSAA and meshlet culling at 1080p, launch counts as in 5e: the test
    scene at ``supersample=2`` (K1 at 3840x2160), bit-equal to the resolve
    of the 3840x2160 frame a ``supersample=1`` Renderer renders, the card's
    resolve bit-equal to the host's, its ``render_animation`` digests the
    resolved frames'; ``make_sphere_field(1_000_000)`` with and without
    ``meshlet_cull`` (K4), the kept share printed, the card's keep mask equal
    to the host's, at most max(2, pixels // 1000) pixels apart, the culled
    frame bit-equal to the kernel frame of the rows killed on the host; the
    field at ``supersample=2`` with ``meshlet_cull`` (K4 at 3840x2176), its
    budgets printed (a clipper drop raises ``ValueError``), within the same
    bound of the unculled resolved frame; each frame's ms (CUDA events)
    and device busy ms beside the card's name and power limit;
7t. the app with ``--debug --trace DIR`` on the test scene for 3 frames:
    the trace JSON holds one
    ``load_scene`` zone, three ``render`` and ``present`` zones and three
    frame spans, and each frame's K1 kernel lies inside a render zone and
    was launched inside one;
6a. one traced frame of each of phase 5a's lit and shadowed 1080p
    showcase renderers, from the glTF and from the bins: busy ms a frame;
6x. each experiment kernel's device time from a trace at its main shape
    (the 1M lattice, its lit rows, the map; the G-buffer kernels also on
    the lit 40K lattice and the test scene; the keyed kernels' calls,
    K10g8's, K10g8g's, K10g8d's, K10vec's and K10vecg's, the sum of their
    device ops, the hit words, the key plane's memset, the work items and
    the resolve, whose count is printed and checked, each op's time
    printed),
    its entry point traced once (the keyed kernels' split into the
    prepare's ops and the kernel's), launcher times, the two prepares'
    times on the 1M lattice and the bounds (the keyed kernels: their
    window pixel evaluations or the bytes their keyed body needs, the
    G-buffer ones at 40K too, the register body's 8x128 tile and chunk
    pairs kept as bound_ms_tiles);
6xv. the visibility-buffer experiments' traces, taken before phase 6's
    untraced loops and their own plain versions (a trace after about 1.2M
    untraced launches loses a kernel record): K10vis and K10trans on the
    1M lattice at 1920x1088 (five launches each; a call is the sum of its
    device ops, the hit words, the key plane's memset, the work items and
    the resolve, whose count is printed and checked, each op's time
    printed), each entry point traced once (device ops, busy ms, idle
    share, and its split into the prepare's ops, the kernel's and the
    colour resolve's) and the colour resolve (``resolve_flat_vis``, torch
    ops) traced once;
6h. the two-class experiments' traces, before phase 6's untraced loops
    too: K10hbm2 and K10scan on the 1M lattice at 1920x1088 (five launches
    each; a call is the sum of its device ops, the hit words of both
    views, the key plane's memset, the work items and the resolve, whose
    count is printed and checked) and each entry point traced once (device
    ops, busy ms, idle share);
6. timing, traces first: each kernel's device time from a torch.profiler
   trace at its main-path shape (K4, K4c, K4g, K4d, K6, K6g, K6d, K9 and
   K9d: the sum of a call's three device operations, the memset, the item
   kernel and the resolve; K3, K3b, K3g, K3d, K5 and K5g the hit words'
   kernel first, so four with more than one work item a tile;
   K4 also on soup1M through ``auto``; the keyed kernels bounded by their
   window pixel evaluations and bytes, ``keyed_work``), and a profiled
   ``render_animation`` run
   per path (test scene K1, 20K lattice K3, 1M lattice K4 and K5, 1M soup
   K4c, 20K lattice K6, the lit paths, and the shadowed test scene, 20K
   lattice (K3d; K6d and K6g) and 1M lattice, the deferred test scene with
   each light set and with bf16 planes, and config 4) giving each
   kernel's time a launch there,
   device-busy ms and device ops per frame and the device's idle share;
   a kernel is timed only from a trace that holds every one of its
   launches (at most three traces).  Then the
   untraced loops: ``render_animation`` ms/frame (CUDA events) per path
   (the lit paths included) and per-stage breakdowns (ms per call, host
   dispatch included, beside each stage's device ops and device-busy ms
   from its trace) of the flat test scene, the flat 1M lattice, the lit
   test scene (geometry, prepare, K2g, crop, LOD, sampling, shading plus
   tonemap, digest) and the shadowed test scene (depth-pass geometry,
   prepare, K2d, G-buffer geometry, prepare, K2g, crop, sampling, PCF,
   shading plus tonemap, digest) and the deferred test scene (geometry,
   prepare, K2g, crop, world position, K7's prepass of planes and light
   bounds, K7, emissive plus tonemap, digest), and config 4's ms/frame;
   K8 and K8b on the --ui draw list at 1080p, and one app frame of the
   test scene without and with --overlay and --ui (device ops, busy ms,
   idle share from a trace; ms/frame on the host clock, read-back
   included); the band kernels K3b, K9, K9g and K9d at their bands and in
   one traced sharded frame each, the per-band prepares and the sharded
   frames' ms, every band rendered in turn on the one card (no multi-card
   time);
4xv. (after phase 6) K10vis (hit bitmap of 8-row groups) and K10trans
    (8-row groups over 4-row chunks) against their plain versions, at
    vis_trans.VIS_ITEMS work items a tile and at 1: depth bits and the
    winning row id equal, the colour resolved on the card equal to the
    same resolve on the CPU: the 40K lattice at 1920x1088 (its plain
    calls give plain_ms), the test scene, the clipped soup, the duplicated
    soup (its resolved frame equal to the soup's without the duplicates:
    ties to the first row), the soup at 128x64 with geometry at 128x56
    (rows 56-63 drawn by each kernel's own extent, all 64 rows held: 451
    pixels for K10vis, none for K10trans), an exact tie at z == 0 between
    a -0.0 and a +0.0 row both ways (the first row and its sign kept), a
    row at z == 1.0 (left clear) and an empty scene; the visible rows of
    each frame equal K5's;
5xv. the two entry points once each on the 1M lattice at 1920x1088,
    launch counts set to 0 just before and read just after (one launch
    each), rows 0-1079 equal K5's frame (RGBA and depth bits), rows
    1080-1087 holding 2610 (K10vis) and 745 (K10trans) drawn pixels; then
    each kernel against its plain version on one 1M prepare, all 1088
    rows, unless the plain version's 40K time scaled to 1M rows exceeds
    60 s;
6xv (untraced). the launchers, the resolve and the two prepares between
    CUDA events at 1M; the bounds: each admitted (tile, row) pair's window
    pixels (its vertices' bbox in the tile within the kernel's extent) x
    OPS_PER_EVAL, or the bytes the keyed body needs (tables, bitmap,
    admitted rows, the two planes), the register body's (4x128 chunk,
    triangle) pairs kept beside them; the resolve by its bytes; ptxas's
    registers, spills and shared memory of each kernel's item, resolve
    and hit-word kernels;
4h. K10hbm2 (short rows on an 8-row window, tall rows over the tile) and
    K10scan (the tall pass, then row-sorted wide records of the short
    rows) against their plain versions, colour and depth bits in every
    row, and the visible rows of each frame against K5's: the 40K lattice
    at 1920x1088 (its plain calls give plain_ms), the test scene, the
    clipped soup, the duplicated soup (its frame equal to the soup's
    without the duplicates), the 1536-triangle stress mix at 256x64, the
    soup at 128x64 with geometry at 128x56 (the pixels each draws in rows
    56-63 printed), the reference test's cross-class exact tie (the tall
    row wins), its z == 1.0 case (one pixel latched that K5 leaves clear),
    its short row at z == -0.0 (K10hbm2 keeps -0.0 as K5 does, K10scan
    stores +0.0) and an empty scene, at hbm2.TWOCLASS_ITEMS work items a
    tile; then the stress mix, the duplicated soup and the 40K lattice at
    1 and 64 items a tile;
5h. the two entry points once each on the 1M lattice at 1920x1088,
    launch counts set to 0 just before and read just after (one launch
    each), rows 0-1079 equal to K5's frame (RGBA and depth bits) but for
    pixels latched at z == 1.0 or a -0.0 stored +0.0 (both counted), the
    pixels drawn in rows 1080-1087 and the short share of the live rows;
    then each kernel against its plain version on one 1M prepare, all
    1088 rows, unless its 40K time scaled to 1M rows exceeds 60 s;
6h (untraced). the launchers and the prepares between CUDA events at 1M,
    and the bounds: each (tile, row) pair's window pixels (its vertices'
    bbox in the tile within the kernel's extent: the tile for a tall row,
    K10hbm2's 8-row window; a K10scan record's rectangle) x OPS_PER_EVAL,
    or the bytes the keyed body needs (tables, admitted rows and records,
    winning rows, two planes); ptxas's registers, spills and shared memory
    of each kernel's item, resolve and hit-word kernels; then where
    the time goes: each kernel with one view's superblocks emptied (each
    pass alone), and K5 over the same padded rows compacted and not;
7. the app CLI writing PNGs: the test scene flat, shadowed, deferred and
   deferred with ``--taa``, the showcase lit; the test scene flat with
   ``--overlay``, ``--orbit`` and ``--ui --orbit``, the showcase lit with
   ``--ui`` (each UI frame against the same run without the UI flag; the
   orbit's frames 0 and 1 differ); the test scene flat with ``--ssaa 2``;
8. hygiene: neither jax, the JAX package (``zrenderer_tpu``) nor PIL
   loaded.

Each kernel's bound is the larger of its inputs and outputs (2 planes
flat, 13 G-buffer, 1 depth-only) moved once at the card's memory rate and
the (tile, triangle) pairs its frame needs, times 4096 pixels and
OPS_PER_EVAL, at the card's instruction rate (phase 1: SMs x 128 lanes x
the maximum SM clock); the keyed kernels' (K4, K4g, K4d; K3, K3b, K3g,
K3d over the hierarchy alone) count each record's and leftover row's
bbox pixels in each tile instead (in the padding rows' tiles the
kernel's extent, ``window_evals``, the counter phase 6h uses too), with
the whole-tile figure kept as bound_ms_tiles (K1 and K2d the same
way, each listed row's and hit hierarchy row's vertex bbox in each tile
it is evaluated in, with the bytes they need: the counts, the live list
entries, each admitted row's staged words once and the planes,
``small_work``), and the bytes their keyed
body needs (``keyed_work``: each span record's ints and z coefficients, each
leftover row's once, for K4, K3 and K3b each distinct winning row's edge
and colour coefficients, for K4g and K3g also its uv, normal and constant
ones, the output planes; K3b's over its band's tiles), with every input
read once kept as bound_ms_inputs.  K7's is the larger of its 11 planes,
mask, bounds, lights and 3 output planes moved once and its (pixel,
listed light) evaluations, each tile's light count times its covered
pixels (uncovered pixels cost nothing), times OPS_PER_LIGHT.  K8's is
the larger of its rows read and its 2 + 3K planes written once and the
draw list's (tile, triangle) pairs times 4096 pixels times
OPS_PER_OVERLAY_EVAL plus its covered (pixel, triangle) times
OPS_PER_OVERLAY_HIT; K8b's the larger of the frame, the count, the output
and the live layers (12 bytes each) moved once and the live layers times
OPS_PER_COMPOSITE_LAYER.  K10g8's, K10g8g's, K10g8d's, K10vec's and
K10vecg's their window
pixels and the bytes their keyed body needs (``x_work``), their register
body's 8x128 tiles and chunks (the granularity at which it gated a
subgroup), 1024 pixels each, kept as bound_ms_tiles; K10vis's and
K10trans's their admitted pairs' window pixels, as K10hbm2's (their
(4x128 chunk, triangle) pairs x 512 x OPS_PER_VIS_PAIR kept as
bound_ms_chunks).

Any failure raises and exits non-zero; without a CUDA card it exits 1 at
once.  The band kernels' bound counts the pairs and the output planes of
their band.  The second-to-last line is the kernels' JSON record (32
kernels), the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import glob
import json
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
SCENE_DIR = os.path.join(HERE, "content", "scenes", "test_scene")
SHOWCASE_DIR = os.path.join(HERE, "content", "scenes", "showcase")
SHOWCASE_SRC = os.path.join(HERE, "content", "scenes", "showcase_src")
SHOWCASE_GLTF = os.path.join(SHOWCASE_SRC, "showcase.gltf")
LIT_GOLDEN = os.path.join(HERE, "tests", "goldens", "lit_160x96.png")
SHADOWED_GOLDEN = os.path.join(HERE, "tests", "goldens",
                               "shadowed_160x96.png")
DEFERRED_GOLDEN = os.path.join(HERE, "tests", "goldens",
                               "deferred_160x96.png")
OVERLAY_GOLDEN = os.path.join(HERE, "tests", "goldens",
                              "overlay_160x96.png")
TAA_GOLDEN = os.path.join(HERE, "tests", "goldens",
                          "taa_converged_160x96.png")
EXPERIMENTS = "zrenderer_tpu/ops/experiments"

# The main-path frame (the reference demo's 1080p) and its padded raster
# target, the card, and the animation length of the timing phase.
DEVICE = "cuda"
WIDTH, HEIGHT = 1920, 1080
# The stats line of the --overlay panel and the --ui windows.
UI_STATS_TEXT = ("FPS: 60.0  CPU time: 16.667 ms  0.01 Mtri/s  0.12 Gpix/s"
                 " | zrenderer-tpu-torch")
PAD_W, PAD_H = 1920, 1088
ANIM_FRAMES = 200
PROFILE_FRAMES = 20  # frames of the profiled render_animation run
LARGE_TRIS = 1_000_000  # the large-scene main path (BASELINE's stretch scene)
# The sphere field of phase 5f's K4-against-plain case at 3840x2176: 12
# spheres, 196 608 triangles, well under 1M (the plain version's time grows
# with the longest tile list).
SMALL_FIELD_TRIS = 200_000
MID_TRIS = 40_000  # above the 32768-row bound, small enough for the plain K5
LARGE_FRAMES = 20  # render_animation frames of the 1M lattice
SOUP_EXTENT = 6.0
# Budgets small enough that the clipped soup at 1080p demotes listed rows
# to the coarse class and coarse rows to the leftover hierarchy.
SMALL_BUDGETS = dict(cap=8, pair_budget=200, coarse_cap=8, coarse_budget=20)

# Bound inputs.  Memory: NVIDIA's H100 SXM data sheet, 3.35 TB/s.
# Instructions: the card's own issue rate, set in phase 1 from
# torch.cuda.get_device_properties(0).multi_processor_count x 128 lanes x
# the maximum SM clock that nvidia-smi --query-gpu=clocks.max.sm reports
# (132 x 128 x 1.98 GHz = 33.5e12 a second on an H100 SXM).  Every kernel
# is built with -fmad=false (ops/_build.py), so it issues no FMA and each
# counted op is one instruction; int32 instructions issue at half this
# rate, which the bounds do not charge.  One pixel evaluation is 3 edge
# functions (5 int ops each), 3 bias tests, 3 int -> float conversions and
# the z interpolation (3 mul + 2 add): 26 ops.
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = None  # set by phase 1 from the card
CUDA_LANES_PER_SM = 128
OPS_PER_EVAL = 26
# K7, one (pixel, listed light) evaluation of csrc/light_tiled.cu's loop:
# the arithmetic instructions it issues, counted by phase 2 in `cuobjdump
# -sass` of the built library, each instantiation on its own
# (``light_loop_ops``): the one-chunk kernel's light loop, the innermost
# backward branch whose body holds the light's LDS.128 and a MUFU, from its
# label to its branch, divided by the passes the compiler unrolled into it
# (its LDS.128 count).  Counted: LIGHT_ARITH_OPCODES, the fp32 adds and
# multiplies, the divide and square-root sequences (MUFU, FFMA, FCHK), the
# clamps and selects (FMNMX, FSETP, FSEL) and the bf16 rounding (F2F).
# Left out, as the kernel's own overhead and not the function's work:
# moves (MOV, UMOV, the HFMA2.MMA constant loads), convergence barriers
# and branches (BSSY, BSYNC, BRA), the slow paths' CALLs, the loop's and
# the addresses' integer ops (IMAD, IADD3, ISETP, LEA, SHF, ULEA, S2UR,
# UIADD3, VIADD; the bf16 widening, a 16-bit shift, among them) and the
# shared loads (LDS).  sm_90a, -O3 -fmad=false gave 112.5 for both
# instantiations on the H100 (PERF.md §6).
LIGHT_LOOP_FUNCTIONS = {
    "k7": "_ZN2zr5light18light_tiled_kernelIfLb0EE",
    "k7_bf16": "_ZN2zr5light18light_tiled_kernelI13__nv_bfloat16Lb0EE",
}
LIGHT_ARITH_OPCODES = frozenset({"FADD", "FMUL", "FFMA", "MUFU", "FCHK",
                                 "FMNMX", "FSETP", "FSEL", "F2F"})
OPS_PER_LIGHT = {}  # "k7", "k7_bf16": set by phase 2
# Registers a thread and static shared memory bytes a block of each
# kernel entry (its mangled name) from ptxas -v: set by phase 2.
PTXAS_REGISTERS = {}
PTXAS_SMEM = {}
PTXAS_SPILLS = {}  # bytes of spill stores
# K8, csrc/overlay.cu's triangle loop: every (pixel, triangle) of a listed
# (tile, triangle) pair costs 3 edge functions (5 int ops each), 3 bias and
# 4 rect compares and 6 ands (28); a covered pixel with a free slot adds 3
# int -> float conversions, 6 interpolations of 5, 4 quantizations of 6
# (clamp 2, mul, add, floor, convert), the 6-op pack, the slot select and
# the count (65).  K8b, a live layer of a pixel: the sample's coordinates,
# floors and fractions (10), 4 wraps of 3, 16 texel unpacks of 4, 4
# channels' bilinear lerp of 9, the colour's 4 unpacks of 4 and the blend
# (2 + 3 x 4): 152 ops.
OPS_PER_OVERLAY_EVAL = 28
OPS_PER_OVERLAY_HIT = 65
OPS_PER_COMPOSITE_LAYER = 152
# K10vis and K10trans, one (pixel, row) of the register body they ran
# before the keyed one (kept for bound_ms_chunks): the 26 ops of
# OPS_PER_EVAL (3 edge functions of 5 int ops, 3 bias tests, 3 int ->
# float conversions, the z plane's 3 mul + 2 add), the depth test z >= 0
# && z < zb (2) and the latch of z and the row id (2): 30 ops.
OPS_PER_VIS_PAIR = 30
# The resolve of a visibility buffer: one table row of 24 int32 gathered
# per covered pixel.
VIS_TABLE_BYTES = 24 * 4
# A plain version held at 1M only when its 40K time, scaled by the rows,
# stays under this.
PLAIN_1M_MAX_S = 60.0

# bench.py's parity threshold against the oracle at 256x144, and
# RASTER_SPEC.md §5's full-pipeline depth bound.
PARITY_MAX_LSB = 1
PARITY_MAX_PX = 50
DEPTH_MAX_ULP = 2
MIN_COVERAGE = 0.05
# The lit frame on the card against the port's CPU frame and the stored
# golden: CUDA's pow/log2/sqrt are not the CPU's, so u8 within 2 LSB.
LIT_MAX_LSB = 2
# The shadowed frame (BASELINE config 2's default 1024^2 map): one PCF tap
# of 9 moves a pixel by up to 255/9 LSB, and CUDA's sqrt and divide may
# move a threshold across an integer, so whole taps may flip on at most
# this share of the covered pixels; u8 within LIT_MAX_LSB elsewhere.
SHADOW_SIZE = 1024
SHADOW_MAX_FLIP_SHARE = 0.005
TAP_MAX_LSB = 29
# The deferred frame held against the port's CPU frame (the CPU plain K7
# lights 256 lights at this size in seconds) and config 4's frames.
DEFERRED_CPU_W, DEFERRED_CPU_H = 480, 270
CONFIG4_FRAMES = 8
# The overlay frame on the card against the port's CPU composite: both
# round every op the same way (IEEE), so 0 LSB is expected; the limit is
# the reference's own rule for one blended layer.  The 160x96 frame against
# overlay_160x96.png, which XLA:CPU's contracted interpolation wrote
# (tests/test_torch_overlay.py): 1 LSB.
OVERLAY_MAX_LSB = 1
OVERLAY_FRAMES = 20  # frames of the untraced overlay timing loops


# ``--phases``: the name prefixes of the phases to run after phases 1 and
# 2 (None: every phase), and the names of the phases it skipped.
PHASE_PREFIXES = None
SKIPPED_PHASES = []


def light_loop_ops(sass: str, prefix: str):
    """K7's light loop in ``cuobjdump -sass`` output, in the function whose
    mangled name starts with ``prefix``: (arithmetic instructions an
    evaluation, the unroll, Counter of the counted opcodes, Counter of the
    left-out ones)."""
    from collections import Counter
    body, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = line.split("Function :")[1].strip().startswith(prefix)
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if inside and m:
            body.append((int(m.group(1), 16), m.group(2).strip()))
    if not body:
        raise RuntimeError(f"no function {prefix} in the disassembly")
    at = {addr: i for i, (addr, _) in enumerate(body)}

    def opcode(ins):
        word = ins.split()[1] if ins.startswith("@") else ins.split()[0]
        return word.split(".")[0]

    loop = None
    for i, (addr, ins) in enumerate(body):
        m = re.search(r"\bBRA (0x[0-9a-f]+)", ins)
        if not m or int(m.group(1), 16) >= addr:
            continue
        span = body[at[int(m.group(1), 16)]:i + 1]
        if (any(opcode(t) == "MUFU" for _, t in span)
                and any("LDS.128" in t for _, t in span)
                and (loop is None or len(span) < len(loop))):
            loop = span
    if loop is None:
        raise RuntimeError(f"{prefix}: no loop with the light's loads")
    ops = Counter(opcode(t) for _, t in loop)
    unroll = sum("LDS.128" in t for _, t in loop)
    counted = Counter({k: n for k, n in ops.items()
                       if k in LIGHT_ARITH_OPCODES})
    left_out = ops - counted
    return sum(counted.values()) / unroll, unroll, counted, left_out


def ptxas_entry(name, table, blocks=None):
    """``table``'s value (PTXAS_REGISTERS, PTXAS_SMEM or PTXAS_SPILLS) for
    the kernel
    ``name`` in namespace zr, or for its instantiation at ``blocks``
    blocks a tile (K1's and K2d's template argument); None when phase 2
    reused an earlier build and printed no log."""
    mangled = f"{len(name)}{name}" + ("E" if blocks is None
                                       else f"ILi{blocks}EE")
    return next((n for e, n in table.items() if mangled in e), None)


def phase(name):
    """Decorator: run the phase at once, print its seconds, return its
    result.  Exceptions propagate (the script exits non-zero).  A phase
    that ``--phases`` leaves out returns None."""
    def run(fn):
        if (PHASE_PREFIXES is not None and name.split()[0] not in ("1", "2")
                and not name.startswith(PHASE_PREFIXES)):
            SKIPPED_PHASES.append(name)
            return None
        print(f"== phase {name}", flush=True)
        t0 = time.perf_counter()
        out = fn()
        print(f"== phase {name}: ok in {time.perf_counter() - t0:.2f} s",
              flush=True)
        return out
    return run


# Trace helpers and the frames' row and input helpers that chip_ab.py
# shares (module level, so that it can run them against another checkout's
# package).


def device_trace(fn):
    """Run ``fn`` once as warm-up, then once under torch.profiler;
    returns (device events, the trace's window in us).  Device events
    are the kernels, copies and memsets of the chrome trace as (name,
    start us, duration us)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up outside the trace
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
    on_device = [(e["name"], float(e["ts"]), float(e["dur"]))
                 for e in timed
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    t0 = min(float(e["ts"]) for e in timed)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in timed)
    return on_device, t1 - t0


def busy_us(events):
    """Union of the device events' intervals, in us."""
    total, end = 0.0, float("-inf")
    for _, ts, dur in sorted(events, key=lambda e: e[1]):
        if ts + dur > end:
            total += ts + dur - max(ts, end)
            end = ts + dur
    return total


def frame_rows(r):
    """The setup rows of a flat renderer's current frame on its device."""
    import torch

    from zrenderer_tpu_torch.ops import geometry as tg

    b = r._buffers()
    mats = torch.from_numpy(r.camera_matrices()).to(r.device)
    return tg.geometry_pipeline_cols(b["corner_cols"], b["tri_node"], mats,
                                     r.config.width, r.config.height)


def light_rows(r):
    """The depth pass's setup rows of a shadowed renderer's current frame:
    the geometry from the light's view into its map."""
    import torch

    from zrenderer_tpu_torch.ops import geometry as tg

    b = r._buffers()
    size = r.config.shadow_size
    light = torch.from_numpy(r._lit_constants()["light_matrices"])
    return tg.geometry_pipeline_cols(b["corner_cols"], b["tri_node"],
                                     light.to(r.device), size, size)


def lit_frame_rows(r):
    """The setup rows of a lit renderer's current frame on its device."""
    import torch

    from zrenderer_tpu_torch.ops import geometry as tg

    b = r._buffers()
    c = r._lit_constants()
    return tg.geometry_pipeline_cols(
        b["corner_cols"], b["tri_node"],
        torch.from_numpy(c["matrices"]).to(r.device), r.config.width,
        r.config.height,
        normal_matrices=torch.from_numpy(c["normal_mats"]).to(r.device),
        material_table=b["materials"])


def deferred_frame_inputs(r):
    """K7's inputs of a deferred renderer's current frame on its device,
    through the frame's own stages (build_deferred_frame)."""
    import torch

    from zrenderer_tpu_torch.engine import passes
    from zrenderer_tpu_torch.ops import shading

    cfg = r.config
    c = {k: torch.from_numpy(v).to(r.device)
         for k, v in r._lit_constants().items()}
    g = passes._gbuffer(r._buffers(), c["matrices"], c["normal_mats"],
                        cfg.width, cfg.height, cfg.pad_height,
                        cfg.pad_width, cfg.binning)
    world = shading.reconstruct_world_pos(g[1], c["inv_view_proj"],
                                          cfg.width, cfg.height)
    return passes.deferred_light_inputs(
        g, world, c["cam_pos"], c["view_proj"], *r.lights, cfg.width,
        cfg.height, cfg.pad_height, cfg.pad_width,
        torch.bfloat16 if cfg.lighting_planes == "bf16" else torch.float32)


def baseline_lights(name):
    """BASELINE config 3's 256 point lights (benchmarks/configs.py
    :121-126): "wide" (every light's influence radius spans the scene) or
    "r2" (colours x 0.008: a radius of about 2 units)."""
    import numpy as np

    rng = np.random.default_rng(3)
    pos = rng.uniform([-6, 0.5, -6], [6, 6, 6], (256, 3)).astype(np.float32)
    col = rng.uniform(0.1, 1.0, (256, 3)).astype(np.float32)
    if name == "r2":
        col = (col * 0.008).astype(np.float32)
    return pos, col


def checker_texture(size=256):
    """The 256x256 checker pattern of BASELINE's lit_1080p cell
    (benchmarks/configs.py checker_texture), built here."""
    import numpy as np

    from zrenderer_tpu_torch.engine.textures import Texture

    y, x = np.mgrid[0:size, 0:size]
    c = (((x // 16) ^ (y // 16)) & 1).astype(np.float32)
    img = np.stack([c, 0.5 + 0.5 * c, 1.0 - 0.5 * c, np.ones_like(c)],
                   axis=-1)
    return Texture.from_array(img.astype(np.float32))


def config4(r, frames):
    """BASELINE config 4 on one card, composed as benchmarks/config4.py
    composes it: per frame the jittered column geometry, K4 over the
    padded target (the large-scene default), the crop and
    ``taa_resolve_packed`` into the history carried from the last frame,
    seeded from a first frame; the digest sums each resolved frame's
    centre pixel and depth.  Returns (digest, the history before the last
    resolve, the last history, the last resolved packed frame, the last
    packed frame)."""
    import numpy as np
    import torch

    from zrenderer_tpu_torch.ops import geometry as tg
    from zrenderer_tpu_torch.ops import raster, taa

    dev = r.device
    b = r._buffers()
    jitters = taa.jitter_sequence(8)
    mats = torch.from_numpy(np.stack([
        r.camera_matrices(jitter=jitters[k % 8]) for k in range(frames)
    ])).to(dev)

    def frame(m):
        ti, tf = tg.geometry_pipeline_cols(b["corner_cols"], b["tri_node"],
                                           m, WIDTH, HEIGHT)
        color, depth = raster.rasterize_setup_binned_hbm(ti, tf, PAD_W,
                                                         PAD_H)
        return color[:HEIGHT, :WIDTH], depth

    hist = taa.taa_init_history_packed(frame(mats[0])[0])
    acc = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(frames):
        packed, depth = frame(mats[i])
        prev = hist
        hist, resolved = taa.taa_resolve_packed(hist, packed)
        centre = (resolved[HEIGHT // 2, WIDTH // 2].to(torch.int64)
                  & 0xFFFFFFFF).to(torch.float32)
        acc = acc + (centre + depth[HEIGHT // 2, WIDTH // 2])
    return acc, prev, hist, resolved, packed


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Chip smoke test of the "
                                     "PyTorch port on one CUDA card.")
    parser.add_argument("--phases", help="comma-separated phase name "
                        "prefixes (e.g. 4h,5h,6h) to run after phases 1 "
                        "and 2; default: every phase")
    args = parser.parse_args(argv)
    global PHASE_PREFIXES
    PHASE_PREFIXES = (tuple(p for p in args.phases.split(",") if p)
                      if args.phases else None)
    SKIPPED_PHASES.clear()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1

    import numpy as np

    from zrenderer_tpu_torch.app.draw_list import DrawList, padded_count
    from zrenderer_tpu_torch.app.main import bind_scene_textures
    from zrenderer_tpu_torch.app.main import main as app_main
    from zrenderer_tpu_torch.app.main import scene_outliner
    from zrenderer_tpu_torch.app.overlay_ui import (
        ImguiOverlay,
        OverlayUI,
        atlas_on,
    )
    from zrenderer_tpu_torch.app.font import UIAtlas
    from zrenderer_tpu_torch.engine import passes
    from zrenderer_tpu_torch.engine.config import RenderConfig
    from zrenderer_tpu_torch.engine.renderer import (
        Renderer,
        frame_digest,
        rgba_digest,
    )
    from zrenderer_tpu_torch.engine.textures import (
        Texture,
        checkerboard,
        textures_from_mesh_data,
    )
    from zrenderer_tpu_torch.engine.upload import (
        flat_scene_to_device,
        flatten_scene,
    )
    from zrenderer_tpu_torch.ops import (
        _build,
        light_kernel,
        overlay,
        raster,
        sampling,
        shading,
        taa,
    )
    from zrenderer_tpu_torch.ops import geometry as tg
    from zrenderer_tpu_torch.ops.mipmap import generate_mip_chain
    from zrenderer_tpu_torch.ops.experiments import raster_group8 as group8
    from zrenderer_tpu_torch.ops.experiments import raster_vec as vec
    from zrenderer_tpu_torch.ops.experiments import (
        raster_vis_trans as vis_trans,
    )
    from zrenderer_tpu_torch.ops.experiments import raster_hbm2 as hbm2
    from zrenderer_tpu_torch.ops.experiments import raster_scanline as scanline
    from zrenderer_tpu_torch.parallel import multihost, tiles
    from zrenderer_tpu_torch.raster_ref import raster_cpu
    from zrenderer_tpu_torch.scene.mesh import V_COLOR, MeshData
    from zrenderer_tpu_torch.scene.procedural import (
        make_sphere_field,
        make_stress_scene,
        make_test_scene,
        make_triangle_soup,
        one_tile_rows,
    )
    from zrenderer_tpu_torch.scene.gltf_runtime import load_gltf
    from zrenderer_tpu_torch.scene.scene import Camera, Node, Scene
    from zrenderer_tpu_torch.utils import native
    from zrenderer_tpu_torch.utils.image import read_image
    from zrenderer_tpu_torch.utils.png import read_png

    dev = torch.device(DEVICE)
    sync = torch.cuda.synchronize
    k1, k3 = raster.raster_small_kernel, raster.raster_hier_kernel
    k4, k4c = raster.raster_binned_kernel, raster.raster_binned_coarse_kernel
    k5, k6 = raster.raster_hbm_kernel, raster.raster_lists_kernel
    k2g, k3g = raster.gbuffer_small_kernel, raster.gbuffer_hier_kernel
    k4g, k5g = raster.gbuffer_binned_kernel, raster.gbuffer_hbm_kernel
    k6g = raster.gbuffer_lists_kernel
    k2d, k3d = raster.depth_small_kernel, raster.depth_hier_kernel
    k4d, k6d = raster.depth_binned_kernel, raster.depth_lists_kernel
    k7, k7b = (light_kernel.tiled_light_kernel,
               light_kernel.tiled_light_bf16_kernel)
    k8, k8b = overlay.overlay_raster_kernel, overlay.overlay_composite_kernel
    k3b, k9 = raster.raster_hier_band_kernel, raster.raster_binned_band_kernel
    k9g = raster.gbuffer_binned_band_kernel
    k9d = raster.raster_binned_band_dist_kernel
    kx8, kx8g, kx8d = group8.KERNELS
    kxv, kxvg = vec.KERNELS
    kxvis, kxtrans = vis_trans.KERNELS
    kxh2, = hbm2.KERNELS
    kxscan, = scanline.KERNELS
    results = {key: {"err": 0.0}
               for key in ("k1", "k3", "k4", "k4_coarse", "k5", "k6",
                           "k2g", "k3g", "k4g", "k5g", "k6g",
                           "k2d", "k3d", "k4d", "k6d", "k7", "k7_bf16",
                           "k8", "k8b", "k3b", "k9", "k9g", "k9d",
                           "k10g8", "k10g8g", "k10g8d", "k10vec",
                           "k10vecg", "k10vis", "k10trans", "k10hbm2",
                           "k10scan")}

    def load_test_scene():
        return (Scene.load(os.path.join(SCENE_DIR, "scene.bin")),
                MeshData.load(os.path.join(SCENE_DIR, "meshes.bin")))

    def clipped_soup():
        """300-triangle soup with 20 triangles pushed through the near
        plane, so the capped clipper emits fan rows."""
        scene, md = make_triangle_soup(300, seed=7, extent=2.0,
                                       behind_camera_fraction=0.1)
        v = md.vertex_data.reshape(-1, 16)
        for t in range(40, 60):
            v[3 * t, 2] += 15.0
        return scene, md

    def edge_soup():
        """A wide soup whose rows, seen into a square map, include bboxes
        clamped to empty at the bottom and right edges and past them;
        at 1920x1080 into the 1920x1088 target its rows draw into the
        padding rows 1080-1087."""
        return make_triangle_soup(600, seed=3, extent=SOUP_EXTENT)

    def tie_soup(duplicate: bool):
        """Soup whose second half repeats the first with other colors:
        every duplicate ties its original's depth exactly."""
        scene, md = make_triangle_soup(200, seed=3, extent=2.0)
        v = md.vertex_data.reshape(-1, 16)
        if duplicate:
            v2 = v.copy()
            v2[:, V_COLOR] = 1.0 - v2[:, V_COLOR]
            v2[:, V_COLOR.stop - 1] = 1.0
            v = np.concatenate([v, v2])
        md2 = MeshData()
        md2.append_mesh(v, np.arange(len(v), dtype=np.uint32))
        return scene, md2

    def long_list(rows, w=128, h=32):
        """prepare_binned_small of ``rows`` at (w, h), raising unless a
        tile's list holds at least 900 rows, so that K1's and K2d's
        staging runs many chunks of STAGE_ROWS."""
        prep = raster.prepare_binned_small(*rows, w, h)
        longest = int(prep[0].max().item())
        print(f"  long list: {longest} rows in the longest tile list "
              f"({prep[0].numel()} tile(s))")
        if longest < 900:
            raise AssertionError(f"long list: {longest} rows, 900 wanted")
        return prep

    def setup_rows(scene, md, width, height, tri_align=64):
        """Port geometry on the card: (tri_i32, tri_f32)."""
        flat = flatten_scene(scene, md, pad=True, tri_align=tri_align)
        b = flat_scene_to_device(flat.host_arrays(), dev)
        vp = tg.view_proj_from_camera(scene.active_camera, width, height)
        mats = np.einsum("nij,jk->nik", flat.node_to_world,
                         vp).astype(np.float32)
        return tg.geometry_pipeline_cols(
            b["corner_cols"], b["tri_node"], torch.from_numpy(mats).to(dev),
            width, height)

    def lit_rows(scene, md, width, height, tri_align=64, seed=0):
        """Port geometry on the card with the lit inputs: random per-draw
        normal matrices and a random material table with one row per
        triangle (seeded), so every triangle carries its own constants."""
        flat = flatten_scene(scene, md, pad=True, tri_align=tri_align)
        b = flat_scene_to_device(flat.host_arrays(), dev)
        vp = tg.view_proj_from_camera(scene.active_camera, width, height)
        mats = np.einsum("nij,jk->nik", flat.node_to_world,
                         vp).astype(np.float32)
        rng = np.random.default_rng(seed)
        nm = rng.standard_normal((len(mats), 3, 3)).astype(np.float32)
        table = rng.random((len(flat.tri_vidx), tg.MATERIAL_COLS),
                           dtype=np.float32)
        return tg.geometry_pipeline_cols(
            b["corner_cols"], b["tri_node"], torch.from_numpy(mats).to(dev),
            width, height, normal_matrices=torch.from_numpy(nm).to(dev),
            material_table=torch.from_numpy(table).to(dev))

    # Blocks that hold the rows of many_supers_rows: in superblock groups 0,
    # 2, 3, 4, 17 and 33 (none in group 1; superblocks 3-35, 150 and 299).
    MANY_SUPERS_BLOCKS = (3, 40, 200, 520, 530, 600, 700, 760, 767, 800, 900,
                          1000, 1029, 1140, 4800, 4805, 9590, 9599)

    def many_supers_rows(lit, w, h, supers=300):
        """A 2000-triangle soup's live rows at (w, h) spread in order over
        the blocks MANY_SUPERS_BLOCKS of ``supers`` superblocks (1 228 800
        rows: 38 groups of 8 superblocks, past the walk's count chunk of 256
        superblocks and its word chunks of 32), every other row live with
        an empty bbox, so the plain versions visit the soup's rows alone."""
        ti, tf = (lit_rows if lit else setup_rows)(
            *make_triangle_soup(2000, seed=13, extent=4.0), w, h)
        live = torch.nonzero(ti[:, tg.I_VALID] > 0).flatten()
        rows = supers * raster.SUPER_BLOCK * raster.RASTER_BLOCK
        big_i = torch.zeros((rows, tg.NI32), dtype=torch.int32, device=dev)
        big_i[:, tg.I_VALID] = 1
        big_i[:, [tg.I_JMIN, tg.I_IMIN]] = 1 << 30
        big_i[:, [tg.I_JMAX, tg.I_IMAX]] = -(1 << 30)
        big_i[:, tg.I_BIAS0:tg.I_BIAS2 + 1] = 2**31 - 1
        big_f = torch.zeros((rows, tg.NF32), dtype=torch.float32, device=dev)
        parts = torch.tensor_split(live, len(MANY_SUPERS_BLOCKS))
        for b, part in zip(MANY_SUPERS_BLOCKS, parts):
            if len(part) > raster.RASTER_BLOCK:
                raise AssertionError("many_supers_rows: a block overflows")
            dst = b * raster.RASTER_BLOCK + torch.arange(len(part),
                                                         device=dev)
            big_i[dst], big_f[dst] = ti[part], tf[part]
        return big_i, big_f

    def compare_gbuffer(key, label, kernel_fn, plain_fn, prepared, w, h,
                        plain_shape=None):
        """G-buffer kernel vs plain version on the same prepared inputs:
        all GBUFFER_PLANES planes must be equal as int32 bits (so -0.0
        and NaN count).  ``plain_shape``: record the plain call's time as
        the kernel's plain_ms."""
        sync()
        gk = kernel_fn(*prepared, w, h)
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        gp = plain_fn(*prepared, w, h)
        end.record()
        sync()
        if plain_shape is not None:
            results[key]["plain_ms"] = start.elapsed_time(end)
            results[key]["plain_shape"] = plain_shape
        if len(gk) != raster.GBUFFER_PLANES or len(gp) != len(gk):
            raise AssertionError(f"{label}: {len(gk)} planes")
        same = [torch.equal(a.contiguous().view(torch.int32),
                            b.contiguous().view(torch.int32))
                for a, b in zip(gk, gp)]
        err = max(
            (raster.unpack_rgba8(gk[0]).int() - raster.unpack_rgba8(gp[0])
             .int()).abs().max().item(),
            max((torch.nan_to_num(a) - torch.nan_to_num(b)).abs().max().item()
                for a, b in zip(gk[1:], gp[1:])))
        covered = gp[1] < 1.0
        cov = covered.float().mean().item()
        layers = torch.unique(gp[12][covered]).numel()
        print(f"  {label}: {w}x{h} bit-exact={all(same)} planes "
              f"{sum(same)}/{len(same)} max_abs_err={err} coverage={cov:.4f}"
              f" distinct layer constants {layers}", flush=True)
        if not all(same):
            raise AssertionError(f"{label}: kernel and plain version differ "
                                 f"in planes {[i for i, x in enumerate(same) if not x]}")
        if cov <= 0.0:
            raise AssertionError(f"{label}: empty frame proves nothing")
        results[key]["err"] = max(results[key]["err"], float(err))
        return gk

    def compare(key, label, kernel_fn, plain_fn, prepared, w, h,
                plain_shape=None):
        """Kernel vs plain version on the same prepared inputs: packed
        color and depth bits must be equal.  ``plain_shape``: record the
        plain call's time (CUDA events) as the kernel's plain_ms, at the
        shape of that name."""
        sync()
        ck, dk = kernel_fn(*prepared, w, h)
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        cp, dp = plain_fn(*prepared, w, h)
        end.record()
        sync()
        if plain_shape is not None:
            results[key]["plain_ms"] = start.elapsed_time(end)
            results[key]["plain_shape"] = plain_shape
        err = max(
            (raster.unpack_rgba8(ck).int() - raster.unpack_rgba8(cp).int())
            .abs().max().item(),
            (dk - dp).abs().max().item(),
        )
        same = (torch.equal(ck, cp)
                and torch.equal(dk.view(torch.int32), dp.view(torch.int32)))
        cov = (dk < 1.0).float().mean().item()
        print(f"  {label}: {w}x{h} bit-exact={same} max_abs_err={err} "
              f"coverage={cov:.4f}", flush=True)
        if not same:
            raise AssertionError(f"{label}: kernel and plain version differ")
        if cov <= 0.0:
            raise AssertionError(f"{label}: empty frame proves nothing")
        results[key]["err"] = max(results[key]["err"], float(err))
        return ck, dk

    def compare_depth(key, label, kernel_fn, plain_fn, prepared, w, h,
                      plain_shape=None):
        """Depth-only kernel vs plain version on the same prepared inputs:
        the one f32 plane equal as int32 bits (so the sign of a zero z
        counts).  ``plain_shape`` as in ``compare``."""
        sync()
        dk = kernel_fn(*prepared, w, h)
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dp = plain_fn(*prepared, w, h)
        end.record()
        sync()
        if plain_shape is not None:
            results[key]["plain_ms"] = start.elapsed_time(end)
            results[key]["plain_shape"] = plain_shape
        same = torch.equal(dk.view(torch.int32), dp.view(torch.int32))
        err = (dk - dp).abs().max().item()
        cov = (dk < 1.0).float().mean().item()
        print(f"  {label}: {w}x{h} bit-exact={same} max_abs_err={err} "
              f"coverage={cov:.4f}", flush=True)
        if not same:
            raise AssertionError(f"{label}: kernel and plain version differ")
        if cov <= 0.0:
            raise AssertionError(f"{label}: empty map proves nothing")
        results[key]["err"] = max(results[key]["err"], float(err))
        return dk

    def tile_pairs(ti, w, h, tile_h=raster.TILE_H, tile_w=raster.TILE_W):
        """(tile, triangle) pairs a frame needs: for every live row with a
        non-empty bbox, the tile_h x tile_w tiles of the (w, h) target its
        bbox touches."""
        jmin, jmax, imin, imax = (ti[:, c].long() for c in (
            tg.I_JMIN, tg.I_JMAX, tg.I_IMIN, tg.I_IMAX))
        live = (ti[:, tg.I_VALID] > 0) & (jmin <= jmax) & (imin <= imax)
        tx = ((jmax.clamp(max=w - 1) // tile_w)
              - (jmin.clamp(min=0) // tile_w) + 1).clamp(min=0)
        ty = ((imax.clamp(max=h - 1) // tile_h)
              - (imin.clamp(min=0) // tile_h) + 1).clamp(min=0)
        return int(torch.where(live, tx * ty, 0).sum().item())

    def set_bound(key, inputs, pairs, w, h, shape, planes=2,
                  tile_px=raster.TILE_H * raster.TILE_W,
                  ops_per_px=OPS_PER_EVAL, evals=None, nbytes=None):
        """The least time the card could take: inputs read once and the
        ``planes`` output planes written once at HBM_BYTES_PER_S (or,
        given, the ``nbytes`` the kernel needs, that figure kept as
        bound_ms_inputs), or ``pairs`` tile evaluations of ``tile_px``
        pixels each (or, given, ``evals`` pixel evaluations, the
        whole-tile figure kept as bound_ms_tiles), at ``ops_per_px`` ops a
        pixel, at CUDA_CORE_OPS_PER_S, whichever is larger."""
        all_bytes = (sum(t.numel() * t.element_size() for t in inputs)
                     + planes * 4 * w * h)
        ops = (pairs * tile_px if evals is None else evals) * ops_per_px
        t_all = all_bytes / HBM_BYTES_PER_S * 1e3
        t_bytes = t_all if nbytes is None else nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
        res = results[key]
        res.update(bound_ms=max(t_bytes, t_ops), pairs=pairs, shape=shape,
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        if evals is not None:
            t_tiles = pairs * tile_px * ops_per_px / CUDA_CORE_OPS_PER_S * 1e3
            res.update(evals=evals, bound_ms_tiles=max(t_all, t_tiles))
            print(f"  bound {key} at {shape}: {evals} window pixel "
                  f"evaluations; whole tiles {pairs * tile_px}, "
                  f"{res['bound_ms_tiles']:.4f} ms")
        if nbytes is not None:
            res.update(bytes=nbytes, bound_ms_inputs=max(t_all, t_ops))
            print(f"  bound {key} at {shape}: {nbytes} bytes needed; every "
                  f"input once {all_bytes} bytes, "
                  f"{res['bound_ms_inputs']:.4f} ms")
        nbytes = all_bytes if nbytes is None else nbytes
        print(f"  bound {key} at {shape}: {pairs} pairs, {ops:.4e} ops -> "
              f"{t_ops:.4f} ms; {nbytes} bytes -> {t_bytes:.4f} ms; bound "
              f"{res['bound_ms']:.4f} ms by {res['bound_by']}")

    def window_evals(rect, ty, tx, visible, padded=None):
        """The (pixel, row) evaluations that (tile, row) pairs need:
        ``rect`` (P, 4) [jmin, jmax, imin, imax] of each pair's row, (ty,
        tx) (P,) its tile.  Inside rows [0, visible) a row covers no pixel
        outside its bbox, so a pair there needs the bbox's pixels in the
        tile.  In a tile that reaches the padding rows the kernel's own
        extent decides the frame: ``padded`` pixels a pair (an int), a
        (P, 4) extent rect's pixels in the tile, or None (the bbox).  (The
        frame's width is a multiple of TILE_W.)"""
        r0, c0 = ty * raster.TILE_H, tx * raster.TILE_W

        def in_tile(r):
            jmin, jmax, imin, imax = r.to(torch.int64).unbind(1)
            return ((torch.minimum(imax, r0 + raster.TILE_H - 1)
                     - torch.maximum(imin, r0) + 1).clamp(min=0)
                    * (torch.minimum(jmax, c0 + raster.TILE_W - 1)
                       - torch.maximum(jmin, c0) + 1).clamp(min=0))

        n = in_tile(rect)
        if padded is not None:
            n = torch.where(r0 + raster.TILE_H > visible,
                            padded if isinstance(padded, int)
                            else in_tile(padded), n)
        return int(n.sum().item())

    def small_work(prep, w, h, planes):
        """K1's or K2d's work on a small prepare: (window pixel
        evaluations, bytes needed).  The evaluations: each (tile, listed
        row) pair and each (tile, hierarchy row) pair whose clamped bbox
        meets the tile (the kernels' admission), counted as the row's
        vertices' pixel bbox in the tile (raster.vertex_bbox, the kernels'
        skip; in the padding rows too).  The bytes: the counts, the live
        list entries, the staged words of each distinct admitted row (its
        vertices, edges, biases and clamped bbox, I_IMAX + 1 ints, and z's
        3 floats) and the ``planes`` output planes."""
        counts, lists, _, _, hier, _ = prep
        tiles_x = w // raster.TILE_W
        n_tiles = counts.numel()
        l2 = lists.reshape(n_tiles, -1)
        live = (torch.arange(l2.shape[1], device=dev)[None, :]
                < counts[:, None])
        tile_l = torch.nonzero(live)[:, 0]
        row_l = l2[live].long()
        hits = raster._tile_hits(
            hier[:, [tg.I_JMIN, tg.I_JMAX, tg.I_IMIN, tg.I_IMAX]],
            h // raster.TILE_H, tiles_x)
        tile_h, row_h = torch.nonzero(hits).unbind(1)
        tile, row = torch.cat([tile_l, tile_h]), torch.cat([row_l, row_h])
        rect = raster.vertex_bbox(hier[row])
        evals = window_evals(rect, tile // tiles_x, tile % tiles_x, h)
        rows = torch.unique(row).numel()
        nbytes = (4 * counts.numel() + 4 * row_l.numel()
                  + rows * ((tg.I_IMAX + 1) * 4 + 12) + planes * 4 * w * h)
        print(f"  small work at {w}x{h}: {row_l.numel()} list entries, "
              f"{row_h.numel()} hierarchy pairs, {rows} distinct rows; "
              f"{evals} window pixel evaluations, {nbytes} bytes")
        return evals, nbytes

    def coarse_pairs(coarse, w, h):
        """K4c's (tile, coarse record) pairs: each record of a tile's bin
        whose bbox meets the tile (raster_binned.cu record_hits).  Returns
        the records' indices into crec_i/crec_f and their tiles."""
        coffsets, crec_i, _ = coarse
        tiles_x = w // raster.TILE_W
        t = torch.arange(tiles_x * (h // raster.TILE_H), device=dev)
        ctiles_x = -(-tiles_x // raster.COARSE_CB)
        b = ((t // tiles_x // raster.COARSE_CB) * ctiles_x
             + t % tiles_x // raster.COARSE_CB)
        n = (coffsets[b + 1] - coffsets[b]).long()
        tile = torch.repeat_interleave(t, n)
        k = (coffsets[b].long()[tile]
             + torch.arange(tile.numel(), device=dev)
             - (torch.cumsum(n, 0) - n)[tile])
        box = crec_i[:, [tg.I_JMIN, tg.I_JMAX, tg.I_IMIN, tg.I_IMAX]][k]
        r0 = (tile // tiles_x) * raster.TILE_H
        c0 = (tile % tiles_x) * raster.TILE_W
        hit = ((box[:, 1] >= c0) & (box[:, 0] < c0 + raster.TILE_W)
               & (box[:, 3] >= r0) & (box[:, 2] < r0 + raster.TILE_H))
        return k[hit], tile[hit]

    def keyed_pairs(prep, w, h, row0=0):
        """The (tile, row) pairs the keyed body evaluates on a record
        prepare (K4, K4c, K4g, K4d; K9 over the h rows from global row
        ``row0``, its spans band-local or the frame's; K9d's (n_src,
        band_tiles + 1) spans, every source's) or on a row-id prepare (K6,
        K6g, K6d: offsets, pair_tri, supers, blocks, hier, tf; each listed
        row read through hier): every span entry of the tiles, K4c's
        (tile, coarse record) pairs (``coarse_pairs``), then every leftover
        (tile, row) pair of the walk; on a hierarchy prepare (K3, K3b, K3g,
        K3d: supers, blocks, rows, tf) the walk's pairs alone.  Returns
        their setup rows (P, NI32), z coefficients (P, 3), row ids, global
        tile rows and tile columns (P,), the number of records read (span
        and coarse entries, each once) and the leftover pairs' rows."""
        box = [tg.I_JMIN, tg.I_JMAX, tg.I_IMIN, tg.I_IMAX]
        za = slice(tg.F_ZA0, tg.F_ZA0 + 3)
        ty0 = row0 // raster.TILE_H
        if len(prep) == 4:
            supers, blocks, hier, tf = prep
            rows, ty, tx = hbm2.rect_pairs(hier[:, box], blocks, supers, w,
                                           row0 + h)
            band = ty >= ty0
            rows, ty, tx = rows[band], ty[band], tx[band]
            return hier[rows], tf[rows, za], rows, ty, tx, 0, rows
        if len(prep) == 6:  # K6, K6g, K6d: row ids into hier/tf
            offsets, pair_tri, supers, blocks, hier, tf = prep
            rec_i = rec_f = None
        else:
            offsets, rec_i, rec_f, supers, blocks, hier, tf = prep[:7]
        tiles_x = w // raster.TILE_W
        tiles = tiles_x * (h // raster.TILE_H)
        offs = offsets if offsets.ndim == 2 else offsets[None]
        if offs.shape[1] != tiles + 1:  # K9's global spans: the band's
            offs = offs[:, ty0 * tiles_x:(ty0 * tiles_x) + tiles + 1]
        rows, ty, tx = hbm2.rect_pairs(hier[:, box], blocks, supers, w,
                                       row0 + h)
        band = ty >= ty0
        rows, ty, tx = rows[band], ty[band], tx[band]
        ri, zs, ids, tys, txs = [], [], [], [], []
        records = 0
        for o in offs:  # each source's spans (one list but for K9d)
            # Records before o[0] sort below tile 0 (off-screen rows' keys)
            # and belong to no span.
            first, end = int(o[0].item()), int(o[-1].item())
            span = (o[1:] - o[:-1]).long()
            tile = torch.repeat_interleave(
                torch.arange(span.numel(), device=span.device), span)
            if rec_i is None:
                listed = pair_tri[first:end].long()
                ri.append(hier[listed])
                zs.append(tf[listed, za])
                ids.append(listed)
            else:
                ri.append(rec_i[first:end, :tg.NI32])
                zs.append(rec_f[first:end, za])
                ids.append(rec_i[first:end, tg.NI32].long())
            tys.append(tile // tiles_x + ty0)
            txs.append(tile % tiles_x)
            records += end - first
        if len(prep) == 8 and prep[7] is not None:  # K4c: a frame
            coffsets, crec_i, crec_f = prep[7]
            k, ctile = coarse_pairs(prep[7], w, h)
            ri.append(crec_i[k, :tg.NI32])
            zs.append(crec_f[k, za])
            ids.append(crec_i[k, tg.NI32].long())
            tys.append(ctile // tiles_x)
            txs.append(ctile % tiles_x)
            records += int((coffsets[-1] - coffsets[0]).item())
        return (torch.cat(ri + [hier[rows]]), torch.cat(zs + [tf[rows, za]]),
                torch.cat(ids + [rows]), torch.cat(tys + [ty]),
                torch.cat(txs + [tx]), records, rows)

    # Evaluations a chunk of k4_winners' scatter (a few hundred MB).
    WINNER_CHUNK = 1 << 22

    def k4_winners(pairs, w, h, depth, strict=False, row0=0):
        """The distinct rows that win a pixel of K4's (K4g's, with
        ``strict`` K3's, K3b's or K3g's) frame, whose edge and colour
        coefficients its resolve reads: each pair of ``keyed_pairs`` at its
        window's pixels (raster.vertex_bbox in the tile) under the kernels'
        edge functions and z, reduced per pixel to the least (z order bits,
        row id) key (``strict``: of z below 1.0, the strict-less test's).
        Raises unless the keys' z is the kernel's ``depth`` plane (the h
        rows from global row ``row0``), up to the sign of a zero."""
        ri, za, ids, ty, tx = pairs[:5]
        jmin, jmax, imin, imax = raster.vertex_bbox(ri.long()).unbind(1)
        r0, c0 = ty * raster.TILE_H, tx * raster.TILE_W
        r_lo, c_lo = torch.maximum(imin, r0), torch.maximum(jmin, c0)
        wide = (torch.minimum(jmax, c0 + raster.TILE_W - 1) - c_lo
                + 1).clamp(min=0)
        area = wide * (torch.minimum(imax, r0 + raster.TILE_H - 1) - r_lo
                       + 1).clamp(min=0)
        ends = torch.cumsum(area, 0)
        keys = torch.full((h * w,), hbm2.KEY_CLEAR, dtype=torch.int64,
                          device=ri.device)
        p0, n = 0, area.numel()
        while p0 < n:
            base = int(ends[p0 - 1].item()) if p0 else 0
            p1 = min(n, max(p0 + 1, int(torch.searchsorted(
                ends, base + WINNER_CHUNK, right=True).item())))
            pair = p0 + torch.repeat_interleave(
                torch.arange(p1 - p0, device=ri.device), area[p0:p1])
            q = (torch.arange(pair.numel(), device=ri.device)
                 - (ends[pair] - area[pair] - base))
            row = r_lo[pair] + q // wide[pair]
            col = c_lo[pair] + q % wide[pair]
            r = ri[pair]
            e = hbm2.edge_windows(r, row, col)[0]
            ok = (e >= r[:, tg.I_BIAS0:tg.I_BIAS0 + 3]).all(1)
            ef, zc = e.to(torch.float32), za[pair]
            z = ((ef[:, 0] * zc[:, 0] + ef[:, 1] * zc[:, 1])
                 + ef[:, 2] * zc[:, 2])
            ok &= (z >= 0.0) & (z < 1.0) if strict else z >= 0.0
            key = (((z.view(torch.int32).to(torch.int64) & 0x7FFFFFFF) << 32)
                   | ids[pair])
            keys.scatter_reduce_(0, (row - row0) * w + col,
                                 torch.where(ok, key, hbm2.KEY_CLEAR),
                                 reduce="amin")
            p0 = p1
        won = keys != hbm2.KEY_CLEAR
        zbits = torch.where(won, (keys >> 32).to(torch.int32),
                            0x3F800000)
        if not torch.equal(zbits, depth.reshape(-1).abs().view(torch.int32)):
            raise AssertionError("the keys do not give the depth plane")
        return int(torch.unique(keys[won] & 0xFFFFFFFF).numel())

    # Bytes of a winning row that K4's resolve reads: 12 edge ints and the
    # z, 1/w and colour coefficients (15 floats); K4g's also its uv and
    # normal coefficients (15 floats) and 6 constants.
    WINNER_BYTES = 12 * 4 + 15 * 4
    WINNER_GBUF_BYTES = WINNER_BYTES + 15 * 4 + 6 * 4

    def keyed_work(prep, w, h, visible, planes, depth=None,
                   winner_bytes=WINNER_BYTES, strict=False, row0=0):
        """K4's, K4c's, K9's, K9d's or K4g's (given its ``depth`` plane) or
        K4d's work on a record prepare, K6's or K6g's (given its plane) or
        K6d's on a row-id prepare, K3's, K3b's or K3g's (given its plane;
        ``strict``) or K3d's on a hierarchy prepare: (window pixel
        evaluations, bytes needed); K3b's, K9's and K9d's over the band,
        the h rows from global row ``row0`` (``visible``: the frame's
        visible rows, global).  The evaluations:
        each pair of ``keyed_pairs`` (K4c: a coarse record in each tile of
        its bin that its bbox meets) at its bbox's pixels in the tile, or
        in the padding rows' tiles at the keyed body's extent
        (raster.vertex_bbox).  The bytes: each span and coarse record's
        ints and 3 z floats (a row-id entry's id, its row's NI32 ints and 3
        z floats, as many), each leftover row's NI32 ints and 3 z floats
        once, each distinct winner's ``winner_bytes`` (K4, K4c, K9, K9d,
        K6, K4g, K6g, K3, K3b, K3g; K4d, K6d and K3d read z from the key)
        and the ``planes`` output planes."""
        pairs = keyed_pairs(prep, w, h, row0)
        ri, ty, tx = pairs[0].long(), pairs[3], pairs[4]
        box = [tg.I_JMIN, tg.I_JMAX, tg.I_IMIN, tg.I_IMAX]
        rect = ri[:, box]
        if len(prep) == 6:
            # Row ids: hier holds the listed rows with their bbox emptied;
            # the geometry's is the vertex bbox clamped to the frame
            # (ops/geometry.py), which the span entries come first with.
            n = pairs[5]
            jmin, jmax, imin, imax = raster.vertex_bbox(ri[:n]).unbind(1)
            rect = torch.cat([torch.stack(
                [jmin.clamp(min=0), jmax.clamp(max=w - 1),
                 imin.clamp(min=0), imax.clamp(max=visible - 1)], 1),
                rect[n:]])
        evals = window_evals(rect, ty, tx, visible, raster.vertex_bbox(ri))
        winners = (0 if depth is None
                   else k4_winners(pairs, w, h, depth, strict, row0))
        nbytes = (pairs[5] * ((tg.NI32 + 1) * 4 + 12)
                  + torch.unique(pairs[6]).numel() * (tg.NI32 * 4 + 12)
                  + winners * winner_bytes + planes * 4 * w * h)
        print(f"  keyed work at {w}x{h} from row {row0}: {pairs[5]} "
              f"span and coarse records, "
              f"{pairs[6].numel()} leftover pairs of "
              f"{torch.unique(pairs[6]).numel()} rows, {winners} winning "
              f"rows; {evals} window pixel evaluations, {nbytes} bytes")
        return evals, nbytes

    def flat_inputs(prepared):
        """The tensors a kernel reads of a prepared tuple: the coarse
        triple unpacked, and of record or row-id arrays only the slots the
        spans use (offsets[-1])."""
        out = list(prepared)
        if len(prepared) == 8:  # K4/K4c: offsets, rec_i, rec_f, ..., coarse
            n = int(prepared[0][-1].item())
            out[1:3] = [prepared[1][:n], prepared[2][:n]]
            coarse = out.pop()
            if coarse is not None:
                cn = int(coarse[0][-1].item())
                out += [coarse[0], coarse[1][:cn], coarse[2][:cn]]
        elif len(prepared) == 6 and prepared[1].ndim == 1:  # K6 pair_tri
            out[1] = prepared[1][:int(prepared[0][-1].item())]
        return out

    def visible_digest(img):
        """frame_digest of the visible frame: the u32 sum of its packed
        RGBA8 pixels.  (render_animation digests the padded plane, whose
        rows 1080-1087 differ between kernels: K4, K4c and K6 list rows
        whose bbox clamps to empty below row 1079 and draw them there, as
        the reference's prepares do; K1, K3 and K5 skip them.)"""
        return float(np.float32(
            np.ascontiguousarray(img).view(np.uint32).astype(np.uint64).sum()))

    def span_stats(offsets):
        spans = (offsets[1:] - offsets[:-1]).float()
        return (int(offsets[-1].item()), int(spans.max().item()),
                float(spans.mean().item()))

    # -- 1. environment ---------------------------------------------------
    @phase("1 environment")
    def card():
        nvcc = _build.find_nvcc()
        nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True,
                                  text=True, check=True).stdout
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
        print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}, "
              f"{torch.cuda.device_count()} card(s): "
              f"{torch.cuda.get_device_name(0)}")
        print(f"  nvcc: {nvcc_ver.strip().splitlines()[-1]}")
        print(f"  card (name, power limit): {smi}")
        global CUDA_CORE_OPS_PER_S
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0])
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        CUDA_CORE_OPS_PER_S = sms * CUDA_LANES_PER_SM * mhz * 1e6
        print(f"  instruction rate: {sms} SMs x {CUDA_LANES_PER_SM} lanes x "
              f"{mhz:.0f} MHz (clocks.max.sm) = "
              f"{CUDA_CORE_OPS_PER_S:.4e} a second")
        return smi

    # -- 2. build ---------------------------------------------------------
    @phase("2 build")
    def build():
        # libzrt (native/zrt_native.cpp, g++) builds beside nvcc's sources.
        native_build = {}

        def build_native():
            t0 = time.perf_counter()
            try:
                native_build["path"] = native.build_library()
            except Exception as e:  # reported after nvcc's build
                native_build["error"] = e
            native_build["s"] = time.perf_counter() - t0

        native_thread = threading.Thread(target=build_native)
        native_thread.start()
        info = _build.build_library()
        _build.load_library()
        native_thread.join()
        if "error" in native_build:
            raise native_build["error"]
        print(f"  {info.path} built in {info.seconds:.2f} s "
              f"(flags: {' '.join(_build.NVCC_FLAGS)})")
        print(f"  {native_build['path']} (g++ {' '.join(native.CXX_FLAGS)}) "
              f"ready in {native_build['s']:.2f} s, alongside")
        entry = None
        for line in info.log.splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill", "error")):
                print(f"  ptxas: {line.strip()}")
            m = re.search(r"Compiling entry function '(\w+)'", line)
            entry = m.group(1) if m else entry
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and entry:
                PTXAS_SPILLS[entry] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and entry:
                PTXAS_REGISTERS[entry] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", line)
                PTXAS_SMEM[entry] = int(m.group(1)) if m else 0
        cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()),
                                 "cuobjdump")
        sass = subprocess.run([cuobjdump, "-sass", str(info.path)],
                              capture_output=True, text=True,
                              check=True).stdout
        for key, prefix in LIGHT_LOOP_FUNCTIONS.items():
            per_eval, unroll, counted, left_out = light_loop_ops(sass, prefix)
            OPS_PER_LIGHT[key] = per_eval
            print(f"  {key} light loop (cuobjdump -sass, {prefix}...): "
                  f"unrolled {unroll}x, {per_eval} arithmetic instructions "
                  "an evaluation ("
                  + ", ".join(f"{k} {n}" for k, n in counted.most_common())
                  + "); left out: "
                  + ", ".join(f"{k} {n}" for k, n in left_out.most_common()))
        smem = _build.load_library().zr_keyed_smem_bytes()
        for key in ("k4", "k4_coarse", "k4g", "k4d", "k9", "k9d", "k6",
                    "k6g", "k6d"):
            results[key]["smem_bytes"] = smem
        print(f"  K4/K4c/K4g/K4d/K9/K9d/K6/K6g/K6d keyed body: {smem} bytes "
              "of dynamic shared memory a block (raster_records_kernel, "
              "raster_records_coarse_keyed_kernel, "
              "gbuffer_records_keyed_kernel, depth_records_kernel, "
              "raster_records_band_keyed_kernel, "
              "raster_records_dist_keyed_kernel, raster_lists_keyed_kernel, "
              "gbuffer_lists_keyed_kernel, depth_lists_keyed_kernel; the "
              "resolve kernels none)")
        small_blocks = _build.load_library().zr_small_blocks_per_tile()
        for key, name in (("k1", "raster_small_kernel"),
                          ("k2d", "depth_small_kernel")):
            print(f"  {key} ({name}) at 1/2/4/8 blocks a tile "
                  f"({small_blocks} on the main path): registers "
                  + "/".join(str(ptxas_entry(name, PTXAS_REGISTERS, b))
                             for b in (1, 2, 4, 8))
                  + ", static shared memory bytes a block "
                  + "/".join(str(ptxas_entry(name, PTXAS_SMEM, b))
                             for b in (1, 2, 4, 8)))
        smem = _build.load_library().zr_keyed_hier_smem_bytes()
        for key in ("k3", "k3b", "k3g", "k3d", "k5", "k5g"):
            results[key]["smem_bytes"] = smem
        print(f"  K3/K3b/K3g/K3d/K5/K5g keyed body: {smem} bytes of dynamic "
              "shared memory a block (raster_hier_keyed_kernel, "
              "raster_hier_band_keyed_kernel, gbuffer_hier_keyed_kernel, "
              "depth_hier_keyed_kernel, raster_hbm_keyed_kernel, "
              f"gbuffer_hbm_keyed_kernel; {raster.HIER_ITEMS} work item(s) "
              "a tile; hier_hit_words_kernel and the resolve kernels none)")
        for key in ("k10hbm2", "k10scan"):
            results[key]["smem_bytes"] = smem
        print(f"  K10hbm2/K10scan keyed body: {smem} bytes of dynamic shared "
              "memory a block (raster_hbm2_keyed_kernel, "
              f"raster_scan_keyed_kernel; {hbm2.TWOCLASS_ITEMS} work "
              "item(s) a tile; twoclass_hit_words_kernel and the resolve "
              "kernels none)")
        for key in ("k10vis", "k10trans", "k10vec", "k10vecg", "k10g8",
                    "k10g8g", "k10g8d"):
            results[key]["smem_bytes"] = smem
        print(f"  K10vis/K10trans keyed body: {smem} bytes of dynamic shared "
              "memory a block (raster_vis_keyed_kernel, "
              f"raster_trans_keyed_kernel; {vis_trans.VIS_ITEMS} work "
              "item(s) a tile; vis_hit_words_kernel, trans_hit_words_kernel "
              "and the resolve kernels none)")
        print(f"  K10vec/K10vecg/K10g8/K10g8g keyed body: {smem} bytes of "
              "dynamic shared memory a block (raster_vec_keyed_kernel, "
              "gbuffer_vec_keyed_kernel, raster_group8_keyed_kernel, "
              f"gbuffer_group8_keyed_kernel; {vec.VEC_ITEMS} and "
              f"{group8.G8_ITEMS} work item(s) a tile; vec_hit_words_kernel, "
              "group8_hit_words_kernel and the resolve kernels none)")
        return info.seconds

    # -- 3. K1 vs plain ---------------------------------------------------
    @phase("3 K1 kernel vs plain version")
    def k1_inputs():
        scene, md = load_test_scene()
        ti, tf = setup_rows(scene, md, WIDTH, HEIGHT, tri_align=256)
        main_prep = raster.prepare_binned_small(ti, tf, PAD_W, PAD_H)
        compare("k1", "(a) test scene", k1, raster.raster_small_plain,
                main_prep, PAD_W, PAD_H, plain_shape="test scene")

        scene, md = clipped_soup()
        ti, tf = setup_rows(scene, md, WIDTH, HEIGHT)
        n_head = tg.head_count(ti.shape[0])
        fans = int((ti[n_head:, tg.I_VALID] > 0).sum().item())
        print(f"  (b) soup: {n_head} head rows, {fans} live clipped-fan rows")
        if fans == 0:
            raise AssertionError("soup has no clipped-fan rows")
        compare("k1", "(b) clipped soup", k1, raster.raster_small_plain,
                raster.prepare_binned_small(ti, tf, PAD_W, PAD_H), PAD_W, PAD_H)

        w, h = 1024, 512
        ti, tf = setup_rows(*tie_soup(True), w, h)
        c_dup, d_dup = compare("k1", "(c) duplicated triangles", k1,
                               raster.raster_small_plain,
                               raster.prepare_binned_small(ti, tf, w, h), w, h)
        ti1, tf1 = setup_rows(*tie_soup(False), w, h)
        c_one, d_one = k1(*raster.prepare_binned_small(ti1, tf1, w, h), w, h)
        if not (torch.equal(c_dup, c_one) and torch.equal(d_dup, d_one)):
            raise AssertionError("(c) a duplicate won an exact depth tie")
        print("  (c) every exact depth tie went to the first-submitted row")

        # (d) The padding rows: the sub-tile blocks skip pixels by the
        # rows' vertices' bbox alone, never by the bbox clamped to the
        # frame, so rows 1080-1087 get every pixel the whole tile drew.
        ti, tf = setup_rows(*edge_soup(), WIDTH, HEIGHT)
        _, d = compare("k1", "(d) edge soup, padding rows", k1,
                       raster.raster_small_plain,
                       raster.prepare_binned_small(ti, tf, PAD_W, PAD_H),
                       PAD_W, PAD_H)
        pad = int((d[HEIGHT:] < 1.0).sum().item())
        print(f"  (d) {pad} pixels drawn in the padding rows "
              f"{HEIGHT}-{PAD_H - 1}")
        if pad == 0:
            raise AssertionError("(d) no pixel drawn in the padding rows")
        # (e) A tile list past 900 rows: many staged chunks a block.
        compare("k1", "(e) one-tile soup, long list", k1,
                raster.raster_small_plain,
                long_list(one_tile_rows(1000, device=dev)), 128, 32)
        return main_prep

    # -- 4. K3 vs plain ---------------------------------------------------
    @phase("4 K3 kernel vs plain version")
    def k3_inputs():
        lattice = make_stress_scene(20000)
        ti, tf = setup_rows(*lattice, WIDTH, HEIGHT, tri_align=256)
        main_prep = raster.prepare_raster_inputs(ti, tf)
        print(f"  lattice: {ti.shape[0]} rows, "
              f"{tg.head_count(ti.shape[0])} head rows")
        t0 = time.perf_counter()
        compare("k3", "lattice20k", k3, raster.raster_hier_plain, main_prep,
                PAD_W, PAD_H, plain_shape="lattice20k")
        print(f"  (plain K3 included: {time.perf_counter() - t0:.1f} s)")
        ti, tf = setup_rows(*clipped_soup(), WIDTH, HEIGHT)
        compare("k3", "clipped soup (binning=hierarchy)", k3,
                raster.raster_hier_plain, raster.prepare_raster_inputs(ti, tf),
                PAD_W, PAD_H)
        return main_prep, lattice

    main_prep_k3, lattice = k3_inputs or (None, make_stress_scene(20000))

    def pair_rows(za_a=None, za_b=None, w=128, h=32, lit=False):
        """tests/test_raster_pallas.py :556-606 on the card: a tall
        triangle A and a short triangle B inside it, submitted after A,
        through the identity matrix; ``za_a``/``za_b`` replace a row's
        z-plane coefficients.  ``lit``: seeded random uv and normals, a
        random normal matrix and a material each."""
        positions = torch.tensor([
            [-0.8, -0.8, 0.5, 1.0], [0.8, -0.8, 0.5, 1.0],
            [0.0, 0.8, 0.5, 1.0], [-0.2, -0.1, 0.3, 1.0],
            [0.2, -0.1, 0.3, 1.0], [0.0, 0.1, 0.3, 1.0]], device=dev)
        attrs = torch.zeros((6, 12), device=dev)
        kw = {}
        if lit:
            rng = np.random.default_rng(6)
            attrs = torch.from_numpy(
                rng.random((6, 12), dtype=np.float32)).to(dev)
            kw = dict(
                normal_matrices=torch.from_numpy(rng.standard_normal(
                    (1, 3, 3)).astype(np.float32)).to(dev),
                material_table=torch.from_numpy(rng.random(
                    (2, tg.MATERIAL_COLS), dtype=np.float32)).to(dev))
        attrs[:3, 0] = 1.0  # A red
        attrs[3:, 1] = 1.0  # B green
        ti, tf = tg.geometry_pipeline(
            positions, attrs,
            torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32,
                         device=dev),
            torch.eye(4, device=dev)[None],
            torch.zeros(6, dtype=torch.int32, device=dev), w, h, **kw)
        a, b = torch.nonzero(ti[:, tg.I_VALID] > 0).flatten().tolist()
        for row, za in ((a, za_a), (b, za_b)):
            if za is not None:
                tf[row, tg.F_ZA0:tg.F_ZA0 + 3] = torch.tensor(za, device=dev)
        return ti, tf

    # K4's and K4d's keyed body: small work items, so that spans and exact
    # ties split across items.
    KEYED_SMALL_ITEMS = 16

    def with_items(kern, item_records, min_items=None):
        """``kern`` run with raster.ITEM_RECORDS set to ``item_records``
        and, given, raster.KEYED_MIN_ITEMS to ``min_items`` (0: the item
        size is never halved) for the call (the wrappers read both at call
        time)."""
        def run(*args):
            saved = raster.ITEM_RECORDS, raster.KEYED_MIN_ITEMS
            raster.ITEM_RECORDS = item_records
            if min_items is not None:
                raster.KEYED_MIN_ITEMS = min_items
            try:
                return kern(*args)
            finally:
                raster.ITEM_RECORDS, raster.KEYED_MIN_ITEMS = saved
        return run

    def keyed_table(offsets, item, n_supers, n_tiles, coffsets=None,
                    tiles_x=None, min_items=None):
        """A keyed record launch's work items as the kernel cuts them at
        ``item`` records an item: its item size (raster.keyed_item_records
        over the lists' records, at ``min_items``, by default
        raster.KEYED_MIN_ITEMS) and raster.keyed_work_items at that size.
        ``offsets``: the launch's spans (K9d: (n_src, tiles + 1)); K4c's
        ``coffsets`` and the frame's ``tiles_x``.  Returns (size, items)."""
        offs = offsets if offsets.ndim == 2 else offsets[None]
        records = int((offs[:, -1] - offs[:, 0]).sum().item())
        cls = ()
        if coffsets is not None:
            records += raster.COARSE_CB**2 * int(
                (coffsets[-1] - coffsets[0]).item())
            cls = (coffsets, tiles_x)
        size = raster.keyed_item_records(
            records, n_tiles, item,
            raster.KEYED_MIN_ITEMS if min_items is None else min_items)
        return size, raster.keyed_work_items(offsets, size, n_supers, *cls)

    def keyed_cases(key):
        """The keyed body's own cases for K4 (``key`` "k4"), K4c
        ("k4_coarse": cap 1, so that every row over more than one tile
        falls to the coarse class), K4g ("k4g", on lit rows, all 13
        planes), K4d ("k4d"), or K6, K6g and K6d ("k6", "k6g" on lit rows,
        "k6d": K4's, K4g's and K4d's body over row-id spans,
        ``prepare_binned_inputs``), each bit-exact against the plain
        version in every row, at the default item size and at
        KEYED_SMALL_ITEMS records: one tile whose span is many items long,
        exact ties split across items, a row at z == 1.0 (K4, K4c, K4g, K6
        and K6g latch it, K4d and K6d do not), -0.0 ties (K4, K4c, K4g, K6
        and K6g keep the lower row id's z, K4d and K6d the first visited
        row's sign), triangles that cover whole tiles, and an empty scene;
        K4c also a coarse bin busy enough to cut each of its tiles into
        several items at the default size."""
        depth, lit = key in ("k4d", "k6d"), key in ("k4g", "k6g")
        kern = {"k4": k4, "k4_coarse": k4c, "k4g": k4g, "k4d": k4d,
                "k6": k6, "k6g": k6g, "k6d": k6d}[key]
        plain = {"k4": raster.raster_binned_plain,
                 "k4_coarse": raster.raster_binned_plain,
                 "k4g": raster.gbuffer_binned_plain,
                 "k4d": raster.depth_binned_plain,
                 "k6": raster.raster_lists_plain,
                 "k6g": raster.gbuffer_lists_plain,
                 "k6d": raster.depth_lists_plain}[key]
        cmp = {"k4": compare, "k4_coarse": compare, "k4g": compare_gbuffer,
               "k4d": compare_depth, "k6": compare, "k6g": compare_gbuffer,
               "k6d": compare_depth}[key]
        rows_of = lit_rows if lit else setup_rows
        prep_kw = (dict(cap=1, coarse_cap=raster.TILE_LISTS_COARSE_CAP)
                   if key == "k4_coarse" else {})

        def prepare(rows, w, h, **kw):
            if key in ("k6", "k6g", "k6d"):
                return raster.prepare_binned_inputs(*rows, w, h, **kw)
            return raster.prepare_binned_hbm_inputs(*rows, w, h,
                                                    **{**prep_kw, **kw})

        def planes(out):
            return [out] if depth else list(out)

        def same(a, b):
            return all(torch.equal(x.contiguous().view(torch.int32),
                                   y.contiguous().view(torch.int32))
                       for x, y in zip(planes(a), planes(b)))

        def check(label, rows, w, h, **kw):
            prep = prepare(rows, w, h, **kw)
            n, longest, _ = span_stats(prep[0])
            cls = ()
            extra = ""
            if len(prep) == 8 and prep[7] is not None:
                cls = (prep[7][0], w // raster.TILE_W)
                extra = f", {span_stats(prep[7][0])[0]} coarse records"
            supers = prep[2 if len(prep) == 6 else 3]
            n_tiles = prep[0].shape[0] - 1
            # ITEM_RECORDS never halved, then KEYED_SMALL_ITEMS.
            items = [keyed_table(prep[0], item, supers.shape[0], n_tiles,
                                 *cls, min_items=min_items)[1]
                     for item, min_items in ((raster.ITEM_RECORDS, 0),
                                             (KEYED_SMALL_ITEMS, None))]
            print(f"  {label}: {n} records, longest span {longest}{extra}, "
                  f"{items[1].shape[0]} items of {KEYED_SMALL_ITEMS} records "
                  f"(most in a tile {int(items[1][:, 2].max().item())}; "
                  f"{int(items[0][:, 2].max().item())} of "
                  f"{raster.ITEM_RECORDS})")
            outs = [cmp(key, f"{label}, items of {item}",
                        with_items(kern, item, min_items), plain, prep, w, h)
                    for item, min_items in ((raster.ITEM_RECORDS, 0),
                                            (KEYED_SMALL_ITEMS, None))]
            return (outs[-1], int(items[1][:, 2].max().item()),
                    int(items[0][:, 2].min().item()))

        packed = rows_of(*make_triangle_soup(4000, seed=5, extent=2.0),
                         128, 32)
        _, most, _ = check("soup packed into one 128x32 tile", packed, 128,
                           32)
        if most < 100:
            raise AssertionError(f"packed soup: {most} items in the tile")
        w, h = 1024, 512
        got = check("duplicated triangles", rows_of(*tie_soup(True), w, h),
                    w, h)[0]
        one = kern(*prepare(rows_of(*tie_soup(False), w, h), w, h), w, h)
        if not same(got, one):
            raise AssertionError(f"{key}: a duplicate won a depth tie "
                                 "across items")
        out = planes(check("z == 1.0 (A's z is 1.0 at one pixel)",
                           pair_rows(za_a=(0.25, 0.0, 0.0), lit=lit),
                           128, 32)[0])
        if not depth:
            c, d = out[0], out[1]
            latched = int(((d == 1.0) & (c != -(1 << 24))).sum().item())
            print(f"    {key} latched {latched} pixel(s) at z == 1.0")
            if latched != 1:
                raise AssertionError(f"{key}: {latched} pixels latched at "
                                     "z == 1.0, 1 expected")
        for za_a, za_b in (((-0.0,) * 3, (0.0,) * 3),
                           ((0.0,) * 3, (-0.0,) * 3)):
            out = planes(check(f"-0.0 tie (A {za_a[0]}, B {za_b[0]})",
                               pair_rows(za_a=za_a, za_b=za_b, lit=lit),
                               128, 32)[0])
            d = out[0] if depth else out[1]
            neg = int((torch.signbit(d) & (d == 0.0)).sum().item())
            print(f"    {neg} pixels at -0.0")
            if (neg > 0) != bool(np.signbit(za_a[0])):
                raise AssertionError(f"{key}: the first row's zero sign "
                                     "was not kept")
        check("whole tiles (A over 1024x512)",
              pair_rows(w=w, h=h, lit=lit), w, h)
        check("clipped soup (whole tiles near the camera)",
              rows_of(*clipped_soup(), WIDTH, HEIGHT), PAD_W, PAD_H)
        t = tg.capped_rows(64)
        ti = torch.zeros((t + (-t) % 64, tg.NI32), dtype=torch.int32,
                         device=dev)
        ti[:, tg.I_JMIN] = 1
        ti[:, tg.I_BIAS0:tg.I_BIAS2 + 1] = 2**31 - 1
        prep = prepare((ti, torch.zeros((ti.shape[0], tg.NF32),
                                        device=dev)), w, h)
        for item, min_items in ((raster.ITEM_RECORDS, 0),
                                (KEYED_SMALL_ITEMS, None)):
            if not same(with_items(kern, item, min_items)(*prep, w, h),
                        plain(*prep, w, h)):
                raise AssertionError(f"{key}: empty scene differs")
        print(f"  empty scene: {key} equals its plain version (clear)")
        if key == "k4_coarse":
            # 6000 triangles of a 512x128 frame (4 x 4 tiles, one coarse
            # bin): thousands of coarse records, so each tile's bin cuts
            # into several items at the default size too.
            _, _, fewest = check(
                "busy coarse bin (6000 triangles, 512x128)",
                rows_of(*make_triangle_soup(6000, seed=11, extent=3.0),
                        512, 128), 512, 128)
            if fewest < 2:
                raise AssertionError(f"busy coarse bin: a tile of {fewest} "
                                     "item(s) at the default size")

    # K3g's and K3d's keyed body: a tile's walk cut into this many work
    # items too, so that exact ties split across items.
    HIER_SPLIT_ITEMS = 64

    def with_hier_items(kern, items):
        """``kern`` run with raster.HIER_ITEMS set to ``items`` for the
        call (the wrappers read it at call time)."""
        def run(*args):
            saved = raster.HIER_ITEMS
            raster.HIER_ITEMS = items
            try:
                return kern(*args)
            finally:
                raster.HIER_ITEMS = saved
        return run

    def hier_cases(key):
        """The keyed hierarchy body's own cases for K3 (``key`` "k3"), K3b
        ("k3b": each case at 1088 rows, its bands at rows 0 and 544), K3g
        ("k3g", on lit rows, all 13 planes), K3d ("k3d"), K5 ("k5") or K5g
        ("k5g", on lit rows, all 13 planes), each bit-exact against the
        plain version in every row at HIER_ITEMS and at HIER_SPLIT_ITEMS
        work items a tile, the two equal (K3b's bands laid side by side
        also equal K3's frame): exact ties between duplicated triangles (to
        the first row, split across items), a row at z == 1.0 (no pixel
        latched), a subnormal and a NaN z, K3g's and K5g's epilogues where
        a row passed with den < 0, -0.0 ties both ways (the first row's
        sign kept), triangles that cover whole tiles, the clipped soup at
        the padded target, an empty scene, and for K5 and K5g a soup spread
        over 300 superblocks (``many_supers_rows``)."""
        depth, band = key == "k3d", key == "k3b"
        kern = {"k3": k3, "k3b": k3b, "k3g": k3g, "k3d": k3d, "k5": k5,
                "k5g": k5g}[key]
        plain = {"k3": raster.raster_hier_plain,
                 "k3b": raster.raster_hier_band_plain,
                 "k3g": raster.gbuffer_hier_plain,
                 "k3d": raster.depth_hier_plain,
                 "k5": raster.raster_hier_plain,
                 "k5g": raster.gbuffer_hbm_plain}[key]
        cmp = {"k3": compare, "k3b": compare, "k3g": compare_gbuffer,
               "k3d": compare_depth, "k5": compare,
               "k5g": compare_gbuffer}[key]
        lit = key in ("k3g", "k5g")
        rows_of = lit_rows if lit else setup_rows

        def planes(out):
            return [out] if depth else list(out)

        def same(a, b):
            return all(torch.equal(x.contiguous().view(torch.int32),
                                   y.contiguous().view(torch.int32))
                       for x, y in zip(planes(a), planes(b)))

        def frame(n, prep, w, h):
            """The kernel's planes of the (w, h) frame at n items a tile:
            K3b's two bands laid side by side."""
            run = with_hier_items(kern, n)
            if not band:
                return run(*prep, w, h)
            bands = [run(*prep, w, h // 2, r0) for r0 in (0, h // 2)]
            return tuple(torch.cat(p) for p in zip(*bands))

        def at_row(fn, r0):
            return lambda *a: fn(*a, r0)

        def check(label, rows, w, h):
            prep = raster.prepare_raster_inputs(*rows)
            live = int((prep[2][:, tg.I_VALID] > 0).sum().item())
            print(f"  {label}: {live} live rows, {prep[1].shape[0]} blocks")
            if band:
                for n in (raster.HIER_ITEMS, HIER_SPLIT_ITEMS):
                    for r0 in (0, h // 2):
                        cmp(key, f"{label}, band at row {r0}, {n} item(s) "
                            "a tile", at_row(with_hier_items(kern, n), r0),
                            at_row(plain, r0), prep, w, h // 2)
            else:
                for n in (raster.HIER_ITEMS, HIER_SPLIT_ITEMS):
                    cmp(key, f"{label}, {n} item(s) a tile",
                        with_hier_items(kern, n), plain, prep, w, h)
            outs = [frame(n, prep, w, h)
                    for n in (raster.HIER_ITEMS, HIER_SPLIT_ITEMS)]
            if not same(*outs):
                raise AssertionError(f"{key} {label}: the item counts differ")
            if band and not same(outs[0], k3(*prep, w, h)):
                raise AssertionError(f"{label}: K3b's bands differ from "
                                     "K3's frame")
            return outs[-1]

        # K3b's cases fill both of its bands, at rows 0 and 544.
        tall = PAD_H if band else None
        w, h = 1024, tall or 512
        got = check("duplicated triangles", rows_of(*tie_soup(True), w, h),
                    w, h)
        one = frame(raster.HIER_ITEMS, raster.prepare_raster_inputs(
            *rows_of(*tie_soup(False), w, h)), w, h)
        if not same(got, one):
            raise AssertionError(f"{key}: a duplicate won a depth tie")
        ph = tall or 32
        out = planes(check("z == 1.0 (A's z is 1.0 at one pixel)",
                           pair_rows(za_a=(0.25, 0.0, 0.0), h=ph, lit=lit),
                           128, ph))
        if not depth:
            latched = int(((out[1] == 1.0)
                           & (out[0] != -(1 << 24))).sum().item())
            print(f"    {key} latched {latched} pixel(s) at z == 1.0")
            if latched:
                raise AssertionError(f"{key}: {latched} pixels latched at "
                                     "z == 1.0, none expected")
        check("subnormal z (A) and NaN z (B)",
              pair_rows(za_a=(1e-45, 0.0, 0.0), za_b=(float("nan"),) * 3,
                        h=ph, lit=lit), 128, ph)
        if lit:  # K3g's or K5g's epilogue where a row passed with den < 0
            ti_n, tf_n = pair_rows(lit=True)
            a = int(torch.nonzero(ti_n[:, tg.I_VALID] > 0)[0].item())
            tf_n[a, tg.F_RW0:tg.F_RW0 + 3] *= -1.0
            out = check("den < 0 (A's 1/w plane negated)", (ti_n, tf_n), 128,
                        32)
            uncovered = (out[1] < 1.0) & (out[0] == -(1 << 24))
            neg = sum(int(torch.signbit(p[uncovered]).sum().item())
                      for p in out[2:7])
            print(f"    {neg} uv/normal values at -0.0 where den < 0")
            if (neg > 0) != (key == "k5g"):
                raise AssertionError(f"{key}: the epilogue's form")
        for za_a, za_b in (((-0.0,) * 3, (0.0,) * 3),
                           ((0.0,) * 3, (-0.0,) * 3)):
            out = planes(check(f"-0.0 tie (A {za_a[0]}, B {za_b[0]})",
                               pair_rows(za_a=za_a, za_b=za_b, h=ph,
                                         lit=lit), 128, ph))
            d = out[0] if depth else out[1]
            neg = int((torch.signbit(d) & (d == 0.0)).sum().item())
            print(f"    {neg} pixels at -0.0")
            if (neg > 0) != bool(np.signbit(za_a[0])):
                raise AssertionError(f"{key}: the first row's zero sign "
                                     "was not kept")
        check(f"whole tiles (A over {w}x{h})",
              pair_rows(w=w, h=h, lit=lit), w, h)
        check("clipped soup (whole tiles near the camera)",
              rows_of(*clipped_soup(), WIDTH, HEIGHT), PAD_W, PAD_H)
        if key in ("k5", "k5g"):
            check("soup over 300 superblocks",
                  many_supers_rows(lit, w, h), w, h)
        t = tg.capped_rows(64)
        ti = torch.zeros((t + (-t) % 64, tg.NI32), dtype=torch.int32,
                         device=dev)
        ti[:, tg.I_JMIN] = 1
        ti[:, tg.I_BIAS0:tg.I_BIAS2 + 1] = 2**31 - 1
        prep = raster.prepare_raster_inputs(
            ti, torch.zeros((ti.shape[0], tg.NF32), device=dev))
        ref = (tuple(torch.cat(p) for p in zip(
            *[plain(*prep, w, h // 2, r0) for r0 in (0, h // 2)]))
            if band else plain(*prep, w, h))
        for n in (raster.HIER_ITEMS, HIER_SPLIT_ITEMS):
            if not same(frame(n, prep, w, h), ref):
                raise AssertionError(f"{key}: empty scene differs")
        print(f"  empty scene: {key} equals its plain version (clear)")

    # -- 4k. K3's, K3b's, K5's and K5g's keyed cases -------------------------
    @phase("4k K3/K3b/K5/K5g keyed hierarchy cases")
    def k3_keyed_cases():
        hier_cases("k3")
        hier_cases("k3b")
        hier_cases("k5")
        hier_cases("k5g")

    # -- 4b. K4, K4c, K5, K6 vs plain ---------------------------------------
    @phase("4b K4/K4c/K5/K6 kernels vs plain versions")
    def streaming_inputs():
        def binned(key, label, ti, tf, w, h, **kw):
            kern = k4c if "coarse_cap" in kw else k4
            prep = raster.prepare_binned_hbm_inputs(ti, tf, w, h, **kw)
            n, longest, mean = span_stats(prep[0])
            hier_live = int((prep[5][:, tg.I_VALID] > 0).sum().item())
            extra = ""
            if prep[7] is not None:
                extra = f", coarse records {int(prep[7][0][-1].item())}"
            print(f"  {label}: {ti.shape[0]} rows, {n} listed pairs (longest "
                  f"span {longest}, mean {mean:.2f}), {hier_live} leftover "
                  f"rows{extra}")
            compare(key, label, kern, raster.raster_binned_plain, prep, w, h)
            return prep

        lattice_mid = make_stress_scene(MID_TRIS)
        ti, tf = setup_rows(*lattice_mid, WIDTH, HEIGHT, tri_align=256)
        if ti.shape[0] <= raster.MAX_RESIDENT_ROWS:
            raise AssertionError("the mid lattice must exceed the row bound")
        binned("k4", "lattice40k", ti, tf, PAD_W, PAD_H)
        binned("k4_coarse", "lattice40k coarse_cap=8", ti, tf, PAD_W, PAD_H,
               coarse_cap=raster.TILE_LISTS_COARSE_CAP)
        t0 = time.perf_counter()
        compare("k5", "lattice40k", k5, raster.raster_hier_plain,
                raster.prepare_raster_inputs(ti, tf), PAD_W, PAD_H,
                plain_shape="lattice40k")
        print(f"  (plain K5 included: {time.perf_counter() - t0:.1f} s)")
        ti20, tf20 = setup_rows(*lattice, WIDTH, HEIGHT, tri_align=256)
        compare("k6", "lattice20k", k6, raster.raster_lists_plain,
                raster.prepare_binned_inputs(ti20, tf20, PAD_W, PAD_H),
                PAD_W, PAD_H, plain_shape="lattice20k")

        ti, tf = setup_rows(*clipped_soup(), WIDTH, HEIGHT)
        binned("k4", "clipped soup", ti, tf, PAD_W, PAD_H)
        binned("k4_coarse", "clipped soup coarse_cap=8", ti, tf, PAD_W,
               PAD_H, coarse_cap=raster.TILE_LISTS_COARSE_CAP)
        compare("k5", "clipped soup", k5, raster.raster_hier_plain,
                raster.prepare_raster_inputs(ti, tf), PAD_W, PAD_H)
        compare("k6", "clipped soup", k6, raster.raster_lists_plain,
                raster.prepare_binned_inputs(ti, tf, PAD_W, PAD_H),
                PAD_W, PAD_H)

        small = SMALL_BUDGETS
        k4_kw = dict(cap=small["cap"], pair_budget=small["pair_budget"])
        prep = binned("k4", "clipped soup, small budget", ti, tf, PAD_W,
                      PAD_H, **k4_kw)
        prep_c = binned("k4_coarse", "clipped soup, small budgets", ti, tf,
                        PAD_W, PAD_H, **small)
        # Without each budget, more rows would be listed.
        free = raster.prepare_binned_hbm_inputs(ti, tf, PAD_W, PAD_H,
                                                cap=small["cap"])
        free_c = raster.prepare_binned_hbm_inputs(
            ti, tf, PAD_W, PAD_H, cap=small["cap"],
            pair_budget=small["pair_budget"], coarse_cap=small["coarse_cap"])
        if not (span_stats(prep[0])[0] < span_stats(free[0])[0]
                and 0 < span_stats(prep_c[7][0])[0]
                < span_stats(free_c[7][0])[0]):
            raise AssertionError("the budget clamps did not engage")
        compare("k6", f"clipped soup, cap={small['cap']}", k6,
                raster.raster_lists_plain,
                raster.prepare_binned_inputs(ti, tf, PAD_W, PAD_H,
                                             cap=small["cap"]),
                PAD_W, PAD_H)

        w, h = 1024, 512
        ti, tf = setup_rows(*tie_soup(True), w, h)
        ti1, tf1 = setup_rows(*tie_soup(False), w, h)
        cases = (
            ("k4", k4, raster.raster_binned_plain,
             lambda a, b: raster.prepare_binned_hbm_inputs(a, b, w, h)),
            ("k4_coarse", k4c, raster.raster_binned_plain,
             lambda a, b: raster.prepare_binned_hbm_inputs(a, b, w, h,
                                                           **small)),
            ("k5", k5, raster.raster_hier_plain,
             lambda a, b: raster.prepare_raster_inputs(a, b)),
            ("k6", k6, raster.raster_lists_plain,
             lambda a, b: raster.prepare_binned_inputs(a, b, w, h,
                                                       cap=small["cap"])),
        )
        for key, kern, plain, prepare in cases:
            c_dup, d_dup = compare(key, "duplicated triangles", kern, plain,
                                   prepare(ti, tf), w, h)
            c_one, d_one = kern(*prepare(ti1, tf1), w, h)
            if not (torch.equal(c_dup, c_one) and torch.equal(d_dup, d_one)):
                raise AssertionError(f"{key}: a duplicate won a depth tie")
        print("  every exact depth tie went to the first-submitted row "
              "(K4, K4c, K5, K6)")
        keyed_cases("k4")
        keyed_cases("k4_coarse")

    # -- 4g. K2g, K3g, K4g, K5g vs plain ----------------------------------
    @phase("4g K2g/K3g/K4g/K5g G-buffer kernels vs plain versions")
    def gbuffer_inputs():
        hier = lambda a, b, w, h: raster.prepare_raster_inputs(a, b)
        cases = {  # key: (kernel, plain version, prepare)
            "k2g": (k2g, raster.gbuffer_small_plain,
                    raster.prepare_binned_small),
            "k3g": (k3g, raster.gbuffer_hier_plain, hier),
            "k4g": (k4g, raster.gbuffer_binned_plain,
                    raster.prepare_binned_hbm_inputs),
            "k5g": (k5g, raster.gbuffer_hbm_plain, hier),
        }

        def check(key, label, rows, w, h, plain_shape=None):
            kern, plain, prepare = cases[key]
            return compare_gbuffer(key, label, kern, plain,
                                   prepare(*rows, w, h), w, h, plain_shape)

        scene, md = load_test_scene()
        check("k2g", "test scene", lit_rows(scene, md, WIDTH, HEIGHT, 256),
              PAD_W, PAD_H, plain_shape="test scene")
        t0 = time.perf_counter()
        check("k3g", "lattice20k",
              lit_rows(*lattice, WIDTH, HEIGHT, 256), PAD_W, PAD_H,
              plain_shape="lattice20k")
        print(f"  (plain K3g included: {time.perf_counter() - t0:.1f} s)")
        rows_mid = lit_rows(*make_stress_scene(MID_TRIS), WIDTH, HEIGHT, 256)
        if rows_mid[0].shape[0] <= raster.MAX_RESIDENT_ROWS:
            raise AssertionError("the mid lattice must exceed the row bound")
        check("k4g", "lattice40k", rows_mid, PAD_W, PAD_H)
        t0 = time.perf_counter()
        check("k5g", "lattice40k", rows_mid, PAD_W, PAD_H,
              plain_shape="lattice40k")
        print(f"  (plain K5g included: {time.perf_counter() - t0:.1f} s)")

        soup = lit_rows(*clipped_soup(), WIDTH, HEIGHT)
        w, h = 1024, 512
        dup = lit_rows(*tie_soup(True), w, h)
        one = lit_rows(*tie_soup(False), w, h)
        for key in cases:
            check(key, "clipped soup", soup, PAD_W, PAD_H)
            g_dup = check(key, "duplicated triangles", dup, w, h)
            kern, _, prepare = cases[key]
            g_one = kern(*prepare(*one, w, h), w, h)
            if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(g_dup, g_one)):
                raise AssertionError(f"{key}: a duplicate won a depth tie")
        print("  every exact depth tie went to the first-submitted row "
              "(K2g, K3g, K4g, K5g; the duplicates carry other colors and "
              "constants)")
        keyed_cases("k4g")
        hier_cases("k3g")

    # -- 4d. K2d, K3d, K4d, K6d and K6g vs plain ---------------------------
    def shadow_renderer(scene_md, binning="auto", device=DEVICE, width=WIDTH,
                        height=HEIGHT, tri_align=256, shadow_size=SHADOW_SIZE):
        r = Renderer(RenderConfig(width=width, height=height,
                                  pipeline="shadowed", binning=binning,
                                  shadow_size=shadow_size,
                                  tri_align=tri_align), device=device)
        r.load_scene(*scene_md)
        r.set_environment()  # BASELINE config 2: white, default light
        return r

    def edge_rows_count(ti, w, h):
        """Live head rows whose bbox clamps to empty at the bottom or right
        edge (imin >= h or jmin >= w): (at the edge, past it)."""
        head = ti[:tg.head_count(ti.shape[0])]
        live = head[:, tg.I_VALID] > 0
        imin, jmin = head[:, tg.I_IMIN], head[:, tg.I_JMIN]
        at = live & ((imin == h) | (jmin == w))
        past = live & ((imin > h) | (jmin > w))
        return int(at.sum().item()), int(past.sum().item())

    @phase("4d K2d/K3d/K4d/K6d depth kernels and K6g vs plain versions")
    def depth_inputs():
        S = SHADOW_SIZE
        hier = lambda a, b, w, h: raster.prepare_raster_inputs(a, b)
        cases = {  # key: (kernel, plain version, prepare)
            "k2d": (k2d, raster.depth_small_plain,
                    raster.prepare_binned_small),
            "k3d": (k3d, raster.depth_hier_plain, hier),
            "k4d": (k4d, raster.depth_binned_plain,
                    raster.prepare_binned_hbm_inputs),
            "k6d": (k6d, raster.depth_lists_plain,
                    raster.prepare_binned_inputs),
        }

        def check(key, label, rows, plain_shape=None):
            kern, plain, prepare = cases[key]
            return compare_depth(key, label, kern, plain,
                                 prepare(*rows, S, S), S, S, plain_shape)

        def same_value(label, planes):
            if not all(torch.equal(p, planes[0]) for p in planes[1:]):
                raise AssertionError(f"{label}: depth planes differ in value")

        check("k2d", "test scene, light view",
              light_rows(shadow_renderer(load_test_scene())),
              plain_shape="test scene")
        rows20 = light_rows(shadow_renderer(lattice))
        t0 = time.perf_counter()
        d3 = check("k3d", "lattice20k, light view", rows20,
                   plain_shape="lattice20k")
        print(f"  (plain K3d included: {time.perf_counter() - t0:.1f} s)")
        d6 = check("k6d", "lattice20k, light view", rows20,
                   plain_shape="lattice20k")
        same_value("lattice20k K3d/K6d", [d3, d6])
        rows40 = light_rows(shadow_renderer((make_stress_scene(MID_TRIS))))
        if rows40[0].shape[0] <= raster.MAX_RESIDENT_ROWS:
            raise AssertionError("the mid lattice must exceed the row bound")
        same_value("lattice40k K4d/K5", [
            check("k4d", "lattice40k, light view", rows40),
            k5(*raster.prepare_raster_inputs(*rows40), S, S)[1]])

        soup = setup_rows(*clipped_soup(), S, S)
        edge = setup_rows(*edge_soup(), S, S)
        at, past = edge_rows_count(edge[0], S, S)
        print(f"  edge soup: {at} rows clamped to empty at the map's edge, "
              f"{past} past it")
        if at == 0 or past == 0:
            raise AssertionError("edge soup: no edge-clamped rows")
        for label, rows in (("clipped soup", soup), ("edge soup", edge)):
            same_value(label, [check(key, label, rows) for key in cases])
        dup = setup_rows(*tie_soup(True), S, S)
        one = setup_rows(*tie_soup(False), S, S)
        for key, (kern, _, prepare) in cases.items():
            d_dup = check(key, "duplicated triangles", dup)
            if not torch.equal(d_dup, kern(*prepare(*one, S, S), S, S)):
                raise AssertionError(f"{key}: duplicates changed the map")
        print("  duplicated triangles leave every map equal by value "
              "(K2d, K3d, K4d, K6d)")
        compare_depth("k2d", "one-tile soup, long list", k2d,
                      raster.depth_small_plain,
                      long_list(one_tile_rows(1000, seed=1, device=dev)),
                      128, 32)
        keyed_cases("k4d")
        keyed_cases("k6d")
        keyed_cases("k6")
        keyed_cases("k6g")
        hier_cases("k3d")

        # K6g: the G-buffer over global pair lists, at the camera's frame.
        gprep = raster.prepare_binned_inputs
        compare_gbuffer("k6g", "lattice20k", k6g, raster.gbuffer_lists_plain,
                        gprep(*lit_rows(*lattice, WIDTH, HEIGHT, 256), PAD_W,
                              PAD_H), PAD_W, PAD_H, plain_shape="lattice20k")
        for label, rows, w, h in (
                ("clipped soup", lit_rows(*clipped_soup(), WIDTH, HEIGHT),
                 PAD_W, PAD_H),
                ("edge soup", lit_rows(*edge_soup(), S, S), S, S)):
            g6 = compare_gbuffer("k6g", label, k6g, raster.gbuffer_lists_plain,
                                 gprep(*rows, w, h), w, h)
            g2 = k2g(*raster.prepare_binned_small(*rows, w, h), w, h)
            if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(g6, g2)):
                raise AssertionError(f"{label}: K6g and K2g differ")
        w, h = 1024, 512
        g_dup = compare_gbuffer("k6g", "duplicated triangles", k6g,
                                raster.gbuffer_lists_plain,
                                gprep(*lit_rows(*tie_soup(True), w, h), w, h),
                                w, h)
        g_one = k6g(*gprep(*lit_rows(*tie_soup(False), w, h), w, h), w, h)
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(g_dup, g_one)):
            raise AssertionError("k6g: a duplicate won a depth tie")
        print("  K6g equals K2g bitwise on the soups; every exact depth tie "
              "went to the first-submitted row")

    # -- 4l. K7 vs plain ----------------------------------------------------
    def golden_lights():
        """The 8 lights of tests/test_golden.py::test_png_golden_deferred."""
        rng = np.random.default_rng(5)
        pos = rng.uniform([-5, 0.5, -5], [5, 5, 5], (8, 3)).astype(np.float32)
        col = rng.uniform(0.2, 2.0, (8, 3)).astype(np.float32)
        return pos, col

    def deferred_renderer(scene_md, lights, planes="f32", device=DEVICE,
                          width=WIDTH, height=HEIGHT, tri_align=256):
        r = Renderer(RenderConfig(width=width, height=height,
                                  pipeline="deferred",
                                  lighting_planes=planes,
                                  tri_align=tri_align), device=device)
        r.load_scene(*scene_md)
        r.set_environment(lights=lights)  # as benchmarks/configs.py does
        return r

    def random_light_inputs(seed, h, w, lights, planes=torch.float32,
                            full_height=None, mask=None):
        """K7's inputs from seeded random planes of an (h, w) frame seen by
        the test scene's camera at 1080p (coverage 0.8, or the (h, w) bool
        ``mask``)."""
        rng = np.random.default_rng(seed)
        cam = load_test_scene()[0].active_camera
        vp = tg.view_proj_from_camera(cam, WIDTH, HEIGHT)
        t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        return light_kernel.light_inputs(
            t(rng.random((h, w, 3), dtype=np.float32)),
            t(rng.standard_normal((h, w, 3)).astype(np.float32)),
            t(rng.uniform([-4, 0, -4], [4, 3, 4], (h, w, 3)).astype(
                np.float32)),
            t(rng.random((h, w)) < 0.8) if mask is None else t(mask),
            t(np.asarray(cam.position, np.float32)), t(lights[0]),
            t(lights[1]), t(vp),
            roughness=t(rng.uniform(0.05, 1.0, (h, w)).astype(np.float32)),
            metallic=t(rng.random((h, w), dtype=np.float32)),
            plane_dtype=planes, full_height=full_height)

    def light_work(inputs, row_offset=0):
        """(light-tile pairs, (pixel, light) evaluations K7 does: each
        tile's light count times its covered pixels, tiles listing no
        light) of K7's inputs."""
        mask, bounds = inputs[1], inputs[2]
        ty, tx = mask.shape[0] // raster.TILE_H, mask.shape[1] // raster.TILE_W
        tiles, _ = light_kernel.tile_light_lists(bounds, ty, tx, row_offset)
        covered = (mask > 0).view(ty, raster.TILE_H, tx, raster.TILE_W).sum(
            dim=(1, 3)).flatten()
        return (int(tiles.sum().item()),
                int((tiles.long() * covered).sum().item()),
                int((tiles == 0).sum().item()))

    light_of = {"k7": k7, "k7_bf16": k7b}

    def compare_light(key, label, inputs, row_offset=0, plain_key=None,
                      uncovered=False):
        """K7 vs its plain version on the same inputs: the 3 output planes
        equal as int32 bits.  ``plain_key``: record the plain call's time
        (CUDA events) under that name.  ``uncovered``: the frame covers no
        pixel (K7 must write zeros)."""
        sync()
        out_k = light_of[key](*inputs, row_offset)
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out_p = light_kernel.tiled_light_plain(*inputs, row_offset)
        end.record()
        sync()
        if plain_key is not None:
            results[key][plain_key] = start.elapsed_time(end)
        same = torch.equal(out_k.view(torch.int32), out_p.view(torch.int32))
        err = (torch.nan_to_num(out_k) - torch.nan_to_num(out_p)).abs().max()
        pairs, evals, empty = light_work(inputs, row_offset)
        cov = (inputs[1] > 0).float().mean().item()
        print(f"  {label}: {inputs[1].shape[1]}x{inputs[1].shape[0]} "
              f"{inputs[0].dtype} planes, {inputs[2].shape[0]} lights, "
              f"row_offset {row_offset}: bit-exact={same} max_abs_err="
              f"{err.item()} coverage={cov:.4f}, {pairs} light-tile pairs, "
              f"{evals} evaluations, {empty} tiles list no light, mean "
              f"{out_k.mean().item():.6f}", flush=True)
        if not same:
            raise AssertionError(f"{label}: K7 and its plain version differ")
        if (cov <= 0.0) != uncovered or pairs == 0:
            raise AssertionError(f"{label}: nothing lit proves nothing")
        if uncovered and out_k.view(torch.int32).any():
            raise AssertionError(f"{label}: an uncovered pixel is not 0")
        results[key]["err"] = max(results[key]["err"], float(err.item()))
        return pairs, evals, empty

    @phase("4l K7 tiled light kernel vs plain version")
    def light_cases():
        scene_md = load_test_scene()
        main = {}
        for name in ("wide", "r2"):
            for planes, key in (("f32", "k7"), ("bf16", "k7_bf16")):
                inputs = deferred_frame_inputs(
                    deferred_renderer(scene_md, baseline_lights(name), planes))
                compare_light(key, f"test scene G-buffer, {name} lights",
                              inputs, plain_key="plain_ms" if name == "wide"
                              else "plain_ms_r2")
                main[name, key] = inputs
        cam = scene_md[0].active_camera
        eye = np.asarray(cam.position, np.float32)
        fwd = np.asarray(cam.forward, np.float32)
        fwd = fwd / np.linalg.norm(fwd)
        pos, col = baseline_lights("r2")
        behind = (np.concatenate([eye - fwd * np.float32(d)
                                  for d in (0.5, 3.0, 40.0)]
                                 ).reshape(3, 3).astype(np.float32))
        lights = (np.concatenate([behind, pos[:61]]),
                  np.concatenate([col[:3] * np.float32(50.0), col[:61]]))
        bounds = light_kernel.light_screen_bounds(
            *(torch.from_numpy(x) for x in lights),
            torch.from_numpy(tg.view_proj_from_camera(cam, WIDTH, HEIGHT)),
            PAD_W, PAD_H)
        whole = int((bounds == torch.tensor([0, PAD_W - 1, 0, PAD_H - 1],
                                            dtype=torch.int32)).all(1).sum())
        print(f"  {whole} of 64 lights get the whole frame (3 behind the "
              "camera)")
        if whole < 3:
            raise AssertionError("the lights behind the camera were culled")
        for key, planes in (("k7", torch.float32), ("k7_bf16",
                                                    torch.bfloat16)):
            compare_light(key, "random planes, lights behind the camera",
                          random_light_inputs(1, PAD_H, PAD_W, lights,
                                              planes))
        # The work-item cut (light_kernel.ITEM_PIXELS covered pixels an
        # item, light_kernel.light_work_items): one covered pixel in a tile,
        # a checkerboard, every pixel, none, and tiles of exactly P and
        # P + 1 covered pixels, f32 and bf16 planes, the wide lights.
        P = light_kernel.ITEM_PIXELS
        th, tw = raster.TILE_H, raster.TILE_W
        one = np.zeros((PAD_H, PAD_W), bool)
        one[th + 5, tw + 70] = True
        edge = np.zeros((PAD_H, PAD_W), bool)
        for (ty, tx), n in (((0, 0), P), ((1, 1), P + 1),
                            ((2, 3), min(2 * P + 1, th * tw))):
            tile = np.zeros(th * tw, bool)
            tile[:n] = True
            edge[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw] = \
                tile.reshape(th, tw)
        masks = {
            "one covered pixel": one,
            "checkerboard": (np.arange(PAD_H)[:, None]
                             + np.arange(PAD_W)[None, :]) % 2 == 1,
            "fully covered": np.ones((PAD_H, PAD_W), bool),
            "empty": np.zeros((PAD_H, PAD_W), bool),
            f"tiles of exactly {P}, {P + 1} and {min(2 * P + 1, th * tw)} "
            "covered pixels": edge,
        }
        items, grid = light_kernel.light_work_items(
            torch.from_numpy(edge), P)
        print(f"  work items of {P} covered pixels: the last mask's "
              f"{torch.unique(items[:, 0] * grid + items[:, 1]).numel()} "
              f"items in a grid of {grid} blocks")
        for name, mask in masks.items():
            for key, planes in (("k7", torch.float32), ("k7_bf16",
                                                        torch.bfloat16)):
                compare_light(key, f"random planes, {name}, wide lights",
                              random_light_inputs(5, PAD_H, PAD_W,
                                                  baseline_lights("wide"),
                                                  planes, mask=mask),
                              uncovered=name == "empty")
        # Two r2-sized lights off the right edge and one on screen.
        side = np.cross(fwd, np.float32([0, 1, 0]))
        side = (side / np.linalg.norm(side)).astype(np.float32)
        off = np.stack([eye + fwd * np.float32(6) + side * np.float32(40),
                        eye + fwd * np.float32(9) + side * np.float32(60)])
        sparse = (np.concatenate([off, pos[1:2]]).astype(np.float32),
                  col[:3])
        empty = compare_light("k7", "random planes, 3 r2 lights, 2 of them "
                              "off screen",
                              random_light_inputs(2, PAD_H, PAD_W, sparse))[2]
        if empty == 0:
            raise AssertionError("no tile was culled to an empty list")
        # A band: a quarter of the frame's rows, from the middle down.
        rows = max(raster.TILE_H, PAD_H // 4 // raster.TILE_H * raster.TILE_H)
        first = PAD_H // 2 // raster.TILE_H * raster.TILE_H
        compare_light("k7", f"random planes, rows {first}-{first + rows - 1}"
                      f" of {PAD_H}",
                      random_light_inputs(3, rows, PAD_W,
                                          baseline_lights("r2"),
                                          full_height=PAD_H),
                      row_offset=first)
        # More lights than a block stages at once (MAX_LIGHTS = 1024):
        # 1500 wide lights go through shared memory in two chunks.
        rng = np.random.default_rng(9)
        many = (rng.uniform([-6, 0.5, -6], [6, 6, 6], (1500, 3)).astype(
                    np.float32),
                rng.uniform(0.1, 1.0, (1500, 3)).astype(np.float32))
        for key, planes in (("k7", torch.float32), ("k7_bf16",
                                                    torch.bfloat16)):
            compare_light(key, "random planes, 1500 wide lights (two "
                          "chunks of the light list)",
                          random_light_inputs(4, PAD_H // 2, PAD_W, many,
                                              planes, full_height=PAD_H))
        return main

    # -- 4o. K8/K8b vs plain ----------------------------------------------
    atlas_dev = atlas_on(UIAtlas(), dev)
    stats_text = UI_STATS_TEXT

    def ui_lines(scene):
        """The --overlay panel's lines: a stats line and the outliner."""
        return [stats_text] + scene_outliner(scene).split("\n")

    def overlay_rows(dl, device=dev):
        """A draw list's setup rows as the overlay pass takes them: padded
        to its power-of-two size, on ``device``."""
        ti, tf = dl.setup(padded_count(len(dl)))
        return (torch.from_numpy(ti).to(device),
                torch.from_numpy(tf).to(device))

    def busy_list(w, h, s):
        """tests/test_overlay_raster.py's busy draw list, its coordinates
        times ``s``: overlapping translucent panels, a rotated textured
        quad, scissored text, a circle and a line."""
        dl = DrawList(w, h)
        dl.add_rect_filled(4 * s, 4 * s, 70 * s, 40 * s, (0.1, 0.1, 0.3, 0.8))
        dl.add_rect(4 * s, 4 * s, 70 * s, 40 * s, (0.4, 0.9, 0.4, 1.0),
                    thickness=s)
        dl.add_rect_filled(30 * s, 20 * s, 100 * s, 58 * s,
                           (0.8, 0.2, 0.1, 0.5))
        dl.add_quad_filled((80 * s, 8 * s), (110 * s, 20 * s),
                           (98 * s, 50 * s), (68 * s, 38 * s),
                           (1.0, 1.0, 0.2, 0.9),
                           uvs=[(0.0, 0.0), (0.5, 0.0), (0.5, 0.5),
                                (0.0, 0.5)])
        dl.push_clip_rect(10 * s, 10 * s, 52 * s, 34 * s)
        dl.add_text(12 * s, 12 * s, "HELLO 123", (0.0, 0.9, 0.0, 1.0),
                    scale=2 * s)
        dl.pop_clip_rect()
        dl.add_circle_filled(100 * s, 45 * s, 12 * s, (0.2, 0.6, 0.9, 0.65),
                             segments=12)
        dl.add_line((0, 60 * s), (127 * s, 30 * s), (1.0, 0.3, 0.8, 0.7),
                    thickness=2 * s)
        return dl

    def overlay_soup(seed, n, w, h):
        """n translucent 2D triangles up to 300 px across, random uv and
        colours (some outside [0, 1]), a third with random scissors (some
        empty), as setup rows on the card."""
        rng = np.random.default_rng(seed)
        verts = np.zeros((n, 3, 8), np.float32)
        centre = rng.uniform([-50, -50], [w + 50, h + 50], (n, 1, 2))
        verts[..., 0:2] = centre + rng.uniform(-150, 150, (n, 3, 2))
        verts[..., 2:4] = rng.uniform(-1, 2, (n, 3, 2))
        verts[..., 4:8] = rng.uniform(-0.2, 1.2, (n, 3, 4))
        verts[..., 7] *= 0.5
        sc = np.tile(np.int32([0, 0, w, h]), (n, 1))
        x0, y0 = rng.integers(-10, w, n), rng.integers(-10, h, n)
        some = np.stack([x0, y0, x0 + rng.integers(-4, w, n),
                         y0 + rng.integers(-4, h, n)], axis=1)
        sc[::3] = some[::3]
        ti, tf = overlay.setup_overlay_triangles(verts, sc, w, h)
        return torch.from_numpy(ti).to(dev), torch.from_numpy(tf).to(dev)

    def random_frame(seed, w, h):
        rng = np.random.default_rng(seed)
        return torch.from_numpy(rng.integers(0, 256, (h, w, 4),
                                             dtype=np.uint8)).to(dev)

    def timed(fn):
        """(fn's result, its ms between CUDA events)."""
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        sync()
        return out, start.elapsed_time(end)

    def compare_overlay(label, ti, tf, w, h, K=overlay.DEFAULT_K,
                        plain_shape=None):
        """K8 vs its plain version on the same rows (count, overflow and
        the 3K layer planes equal as int32 bits), then K8b vs its plain
        version on K8's planes and a random frame (the u8 frames equal).
        ``plain_shape``: record both plain calls' times as plain_ms."""
        sync()
        ck, ok_, lk = k8(ti, tf, w, h, K)
        (cp, op, lp), ms8 = timed(
            lambda: overlay.rasterize_overlay_plain(ti, tf, w, h, K))
        same = all(torch.equal(a.contiguous().view(torch.int32),
                               b.contiguous().view(torch.int32))
                   for a, b in zip((ck, ok_, *lk), (cp, op, *lp)))
        err = max((a - b).abs().max().item() for a, b in zip(lk[:2],
                                                             lp[:2]))
        frame = random_frame(seed=w + K, w=w, h=h)
        outk = k8b(frame, ck, lk, atlas_dev, K)
        outp, ms8b = timed(
            lambda: overlay.composite_layers_plain(frame, cp, lp, atlas_dev,
                                                   K))
        same_b = torch.equal(outk, outp)
        err_b = (outk.int() - outp.int()).abs().max().item()
        if plain_shape is not None:
            results["k8"].update(plain_ms=ms8, plain_shape=plain_shape)
            results["k8b"].update(plain_ms=ms8b, plain_shape=plain_shape)
        live = int(ck.sum().item())
        changed = (outk[..., :3] != frame[..., :3]).any(-1).float().mean()
        print(f"  {label}: {w}x{h} K={K} {ti.shape[0]} rows "
              f"({int((ti[:, tg.I_VALID] > 0).sum().item())} live): K8 "
              f"bit-exact={same} (max_abs_err {err}), K8b bit-exact={same_b}"
              f" (max {err_b} LSB); max count {int(cp.max().item())}, "
              f"pixels over K {int((op > 0).sum().item())}, live layers "
              f"{live}, pixels whose colour changed {changed.item():.4f}",
              flush=True)
        if not (same and same_b):
            raise AssertionError(f"{label}: K8/K8b and their plain versions "
                                 "differ")
        if live == 0:
            raise AssertionError(f"{label}: nothing drawn proves nothing")
        results["k8"]["err"] = max(results["k8"]["err"], float(err))
        results["k8b"]["err"] = max(results["k8b"]["err"], float(err_b))
        return cp, op

    @phase("4o K8/K8b overlay kernels vs plain versions")
    def overlay_cases():
        scene = load_test_scene()[0]
        main = {
            "OverlayUI": overlay_rows(OverlayUI(WIDTH, HEIGHT, device=dev)
                                      .draw_list(ui_lines(scene))),
            "ImguiOverlay": overlay_rows(ImguiOverlay(
                WIDTH, HEIGHT, device=dev).draw_list(stats_text, scene)),
        }
        for name, rows in main.items():
            compare_overlay(f"{name} draw list of the test scene", *rows,
                            WIDTH, HEIGHT,
                            plain_shape=("--ui windows" if name ==
                                         "ImguiOverlay" else None))
        compare_overlay("busy draw list x15", *overlay_rows(
            busy_list(WIDTH, HEIGHT, 15)), WIDTH, HEIGHT)
        _, over = compare_overlay("random soup of 4096 translucent "
                                  "triangles with scissors",
                                  *overlay_soup(1, 4096, WIDTH, HEIGHT),
                                  WIDTH, HEIGHT)
        if int(over.max().item()) == 0:
            raise AssertionError("the soup never overflows K")
        for k in overlay.KERNEL_K:
            dl = DrawList(WIDTH, HEIGHT)
            for _ in range(k + 3):
                dl.add_rect_filled(WIDTH // 10, HEIGHT // 10, WIDTH // 2,
                                   HEIGHT // 2, (1.0, 1.0, 1.0, 0.1))
            cnt, over = compare_overlay(f"overflow stack of {k + 3} rects",
                                        *overlay_rows(dl), WIDTH, HEIGHT,
                                        K=k)
            i, j = HEIGHT * 3 // 10, WIDTH * 3 // 10
            if (int(cnt[i, j].item()), int(over[i, j].item())) != (k, 3):
                raise AssertionError("overflow stack: count K, overflow 3 "
                                     "expected")
        compare_overlay("random soup, not a tile multiple",
                        *overlay_soup(2, 300, 1000, 517), 1000, 517)
        # K8b's scalar tail: 127 x 33 = 4191 pixels, 3 past the last quad.
        compare_overlay("random soup, a pixel count not a multiple of 4",
                        *overlay_soup(3, 200, 127, 33), 127, 33)
        # No live layer anywhere: K8b's copy path alone, over the --ui
        # frame's layer planes with every count 0.
        _, _, lay = k8(*main["ImguiOverlay"], WIDTH, HEIGHT)
        frame = random_frame(seed=5, w=WIDTH, h=HEIGHT)
        cnt0 = torch.zeros((HEIGHT, WIDTH), dtype=torch.int32, device=dev)
        outk = k8b(frame, cnt0, lay, atlas_dev)
        outp = overlay.composite_layers_plain(frame, cnt0, lay, atlas_dev)
        want = frame.clone()
        want[..., 3] = 255
        same = torch.equal(outk, outp) and torch.equal(outk, want)
        print(f"  no live layer, {WIDTH}x{HEIGHT}: K8b bit-exact against its "
              f"plain version and the frame with alpha 255 {same}")
        if not same:
            raise AssertionError("no live layer: K8b is not the frame")
        # K8b on views off a 16-byte boundary: the frame, then the frame
        # and the count, at a 4-byte offset into larger buffers (the
        # wrapper copies them before the launch).
        w5, h5 = 1000, 517
        ck, _, lk = k8(*overlay_soup(4, 300, w5, h5), w5, h5)
        fbuf = random_frame(seed=6, w=w5 * h5 + 1, h=1).reshape(-1)
        fview = fbuf[4:].view(h5, w5, 4)
        cbuf = torch.zeros(h5 * w5 + 1, dtype=torch.int32, device=dev)
        cview = cbuf[1:].view(h5, w5)
        cview.copy_(ck)
        for label, cnt in (("the frame", ck), ("the frame and the count",
                                               cview)):
            aligned = overlay.composite_aligned(fview, cnt)
            outk = k8b(fview, cnt, lk, atlas_dev)
            outp = overlay.composite_layers_plain(fview, cnt, lk, atlas_dev)
            outa = k8b(fview.clone(), ck, lk, atlas_dev)
            same = torch.equal(outk, outp) and torch.equal(outk, outa)
            err = (outk.int() - outp.int()).abs().max().item()
            results["k8b"]["err"] = max(results["k8b"]["err"], float(err))
            print(f"  {label} at a 4-byte offset, {w5}x{h5}: off a 16-byte "
                  f"boundary {not aligned}, K8b bit-exact against its plain "
                  f"version and the kernel on a copy {same} (max {err} LSB), "
                  f"live layers {int(ck.sum().item())}")
            if aligned or not same:
                raise AssertionError(f"{label} at an offset: K8b differs")
        return main

    # -- 5. main path -----------------------------------------------------
    counts = {}  # launches of each kernel in its main-path run
    @phase("5 main path")
    def launches():
        scene, md = load_test_scene()
        k1.launches = 0
        k3.launches = 0

        r = Renderer(RenderConfig(width=WIDTH, height=HEIGHT), device=DEVICE)
        r.load_scene(scene, md)
        img, depth = r.render_and_read()
        cov = (img[..., :3].sum(-1) > 0).mean()
        print(f"  test scene {WIDTH}x{HEIGHT}: {img.shape} coverage={cov:.4f}"
              f", K1 launches so far {k1.launches}")
        if img.shape != (HEIGHT, WIDTH, 4) or not np.isfinite(depth).all():
            raise AssertionError("bad main-path frame")
        if cov <= MIN_COVERAGE or k1.launches == 0:
            raise AssertionError("test-scene frame empty or not via K1")

        pw, ph = 256, 144
        rs = Renderer(RenderConfig(width=pw, height=ph), device=DEVICE)
        rs.load_scene(scene, md)
        img_dev, depth_dev = rs.render_and_read()
        img_cpu, depth_cpu = raster_cpu.render_scene_cpu(scene, md, pw, ph)
        diff = np.abs(img_dev.astype(np.int32) - img_cpu.astype(np.int32))
        bad = int((diff > 0).any(-1).sum())
        both = (depth_dev < 1.0) & (depth_cpu < 1.0)
        ulp = np.abs(depth_dev.view(np.int32).astype(np.int64)
                     - depth_cpu.view(np.int32).astype(np.int64))[both]
        cov_diff = int(((depth_dev < 1.0) != (depth_cpu < 1.0)).sum())
        print(f"  parity vs NumPy oracle at {pw}x{ph}: max_diff="
              f"{int(diff.max())} LSB, {bad}/{pw * ph} px differ, coverage "
              f"mismatch {cov_diff} px, depth max {int(ulp.max())} ulp")
        if int(diff.max()) > PARITY_MAX_LSB or bad >= PARITY_MAX_PX:
            raise AssertionError("256x144 frame outside the parity threshold")
        if int(ulp.max()) > DEPTH_MAX_ULP or cov_diff >= PARITY_MAX_PX:
            raise AssertionError("256x144 depth outside the parity threshold")

        k3_before = k3.launches
        rl = Renderer(RenderConfig(width=WIDTH, height=HEIGHT), device=DEVICE)
        rl.load_scene(*lattice)
        img_l, _ = rl.render_and_read()
        cov_l = (img_l[..., :3].sum(-1) > 0).mean()
        print(f"  lattice {WIDTH}x{HEIGHT}: coverage={cov_l:.4f}, K3 launches "
              f"{k3.launches - k3_before}")
        if cov_l <= MIN_COVERAGE or k3.launches == k3_before:
            raise AssertionError("lattice frame empty or not via K3")
        counts.update(k1=k1.launches, k3=k3.launches)
        print(f"  launches in the main-path run: {counts}")
        return r, rl

    r_scene, r_lattice = launches or (None,) * 2

    # -- 5b. large-scene paths ----------------------------------------------
    kernel_of = {"k1": k1, "k3": k3, "k4": k4, "k4_coarse": k4c, "k5": k5,
                 "k6": k6, "k2g": k2g, "k3g": k3g, "k4g": k4g, "k5g": k5g,
                 "k6g": k6g, "k2d": k2d, "k3d": k3d, "k4d": k4d, "k6d": k6d,
                 "k7": k7, "k7_bf16": k7b, "k8": k8, "k8b": k8b,
                 "k3b": k3b, "k9": k9, "k9g": k9g, "k9d": k9d,
                 "k10g8": kx8, "k10g8g": kx8g, "k10g8d": kx8d,
                 "k10vec": kxv, "k10vecg": kxvg, "k10vis": kxvis,
                 "k10trans": kxtrans, "k10hbm2": kxh2, "k10scan": kxscan}

    def drive(label, scene_md, binning, key):
        """One frame through Renderer.render_and_read with every launch
        count set to 0 just before and read just after; returns the
        renderer, the frame, the frame's setup rows, the launch count of
        ``key`` and the frame's pair-list prepare (None for K5)."""
        torch.cuda.reset_peak_memory_stats()
        for kern in kernel_of.values():
            kern.launches = 0
        r = Renderer(RenderConfig(width=WIDTH, height=HEIGHT,
                                  binning=binning), device=DEVICE)
        r.load_scene(*scene_md)
        t0 = time.perf_counter()
        img, depth = r.render_and_read()
        wall = (time.perf_counter() - t0) * 1000.0
        launched = {k: kern.launches for k, kern in kernel_of.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        ti, tf = frame_rows(r)
        cov = (img[..., :3].sum(-1) > 0).mean()
        print(f"  {label} {WIDTH}x{HEIGHT} binning={binning}: {ti.shape[0]} "
              f"rows, {tile_pairs(ti, PAD_W, PAD_H)} (tile, triangle) pairs,"
              f" coverage={cov:.4f}, digest {visible_digest(img):.6e}, "
              f"peak memory {peak:.3f} GiB, first "
              f"frame {wall:.1f} ms (host clock, build and warm-up "
              f"included), launches {launched}")
        if img.shape != (HEIGHT, WIDTH, 4) or not np.isfinite(depth).all():
            raise AssertionError(f"{label}: bad frame")
        if cov <= MIN_COVERAGE or launched[key] == 0:
            raise AssertionError(f"{label}: frame empty or not via {key}")
        prep = None
        if binning != "hierarchy":  # the pair lists of the frame
            if ti.shape[0] > raster.MAX_RESIDENT_ROWS:
                kw = {}
                if binning == "tile_lists":
                    kw["coarse_cap"] = raster.TILE_LISTS_COARSE_CAP
                prep = raster.prepare_binned_hbm_inputs(ti, tf, PAD_W, PAD_H,
                                                        **kw)
                hier, coarse = prep[5], prep[7]
            else:
                prep = raster.prepare_binned_inputs(ti, tf, PAD_W, PAD_H)
                hier, coarse = prep[4], None
            n, longest, mean = span_stats(prep[0])
            print(f"    listed pairs {n} (offsets[-1]), longest span "
                  f"{longest}, mean span {mean:.2f}, leftover-row pairs "
                  f"{tile_pairs(hier, PAD_W, PAD_H)}")
            if coarse is not None:
                cn, clong, cmean = span_stats(coarse[0])
                print(f"    coarse records {cn}, longest coarse span "
                      f"{clong}, mean {cmean:.2f}")
        return r, (img, depth), (ti, tf), launched[key], prep

    @phase("5b large-scene paths")
    def large():
        lattice_big = make_stress_scene(LARGE_TRIS)
        r4, f4, rows_lattice, counts["k4"], prep4 = drive(
            "lattice1M", lattice_big, "auto", "k4")
        # The main path's K4 inputs against the plain version; its time
        # is K4's plain_ms (one step per record of the longest span).
        _, d4 = compare("k4", "lattice1M", k4, raster.raster_binned_plain,
                        prep4, PAD_W, PAD_H, plain_shape="lattice1M")
        pad4 = int((d4[HEIGHT:] < 1.0).sum().item())
        results["k4"]["pad_pixels_1m"] = pad4
        print(f"  lattice1M K4: {pad4} pixels drawn in rows "
              f"{HEIGHT}-{PAD_H - 1} (the padding rows)")
        if pad4 == 0:
            raise AssertionError("lattice1M: K4 drew no padding-row pixel")
        del prep4
        r5, f5, _, counts["k5"], _ = drive("lattice1M", lattice_big,
                                           "hierarchy", "k5")
        same = (np.array_equal(f4[0], f5[0])
                and np.array_equal(f4[1].view(np.int32),
                                   f5[1].view(np.int32))
                and visible_digest(f4[0]) == visible_digest(f5[0]))
        print(f"  lattice1M K4 frame == K5 frame (color, depth bits, "
              f"digest): {same}")
        if not same:
            raise AssertionError("lattice1M: K4 and K5 frames differ")

        soup_big = make_triangle_soup(LARGE_TRIS, seed=1, extent=SOUP_EXTENT)
        r4c, fc, rows_soup, counts["k4_coarse"], prepc = drive(
            "soup1M", soup_big, "tile_lists", "k4_coarse")
        # K4c's main-path inputs, coarse class included, against the plain
        # version; its time is K4c's plain_ms.
        if int(prepc[7][0][-1].item()) == 0:
            raise AssertionError("soup1M: the coarse class is empty")
        cc, dc = compare("k4_coarse", "soup1M", k4c,
                         raster.raster_binned_plain, prepc, PAD_W, PAD_H,
                         plain_shape="soup1M")
        cs, ds = with_items(k4c, KEYED_SMALL_ITEMS)(*prepc, PAD_W, PAD_H)
        sync()
        same = (torch.equal(cs, cc)
                and torch.equal(ds.view(torch.int32), dc.view(torch.int32)))
        print(f"  soup1M K4c at {KEYED_SMALL_ITEMS} records an item: "
              f"bit-exact {same}")
        if not same:
            raise AssertionError(f"soup1M: K4c at {KEYED_SMALL_ITEMS} "
                                 "records an item differs")
        del prepc, cc, dc, cs, ds
        _, fp, _, _, _ = drive("soup1M", soup_big, "auto", "k4")
        same = (np.array_equal(fc[0], fp[0])
                and np.array_equal(fc[1].view(np.int32),
                                   fp[1].view(np.int32))
                and visible_digest(fc[0]) == visible_digest(fp[0]))
        print(f"  soup1M K4c frame == K4 frame (color, depth bits, digest): "
              f"{same}")
        if not same:
            raise AssertionError("soup1M: K4c and K4 frames differ")
        del soup_big

        r6, _, rows_k6, counts["k6"], _ = drive("lattice20k", lattice,
                                                "tile_lists", "k6")
        print(f"  launches in the large-scene runs: "
              f"{ {k: counts[k] for k in ('k4', 'k5', 'k4_coarse', 'k6')} }")
        return (r4, r5, r4c, r6, rows_lattice, rows_soup, rows_k6,
                lattice_big)

    (r_k4, r_k5, r_k4c, r_k6, rows_lattice, rows_soup, rows_k6,
     lattice_big) = large or (None,) * 8

    # -- 5l. lit main path --------------------------------------------------
    def lit_renderer(scene_md, binning="auto", device=DEVICE, width=WIDTH,
                     height=HEIGHT, texture=None, tri_align=256):
        r = Renderer(RenderConfig(width=width, height=height,
                                  pipeline="lit", binning=binning,
                                  tri_align=tri_align), device=device)
        r.load_scene(*scene_md)
        if texture is not None:
            r.set_environment(texture=texture)
        return r

    def drive_lit(label, r, key):
        """One lit frame through Renderer.render_and_read with every launch
        count set to 0 just before and read just after."""
        for kern in kernel_of.values():
            kern.launches = 0
        t0 = time.perf_counter()
        img, depth = r.render_and_read()
        wall = (time.perf_counter() - t0) * 1000.0
        launched = {k: kern.launches for k, kern in kernel_of.items()}
        cov = (depth < 1.0).mean()
        print(f"  lit {label} {img.shape[1]}x{img.shape[0]} binning="
              f"{r.config.binning}: coverage={cov:.4f}, first frame "
              f"{wall:.1f} ms (host clock, warm-up included), launches "
              f"{ {k: n for k, n in launched.items() if n} }", flush=True)
        if img.shape[:2] != (r.config.height, r.config.width):
            raise AssertionError(f"lit {label}: bad frame shape")
        if not np.isfinite(depth).all() or cov <= MIN_COVERAGE:
            raise AssertionError(f"lit {label}: frame empty or not finite")
        if launched[key] != 1 or sum(launched.values()) != 1:
            raise AssertionError(f"lit {label}: expected one {key} launch, "
                                 f"got {launched}")
        return img, depth, launched[key]

    def lsb_diff(a, b):
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        return int(d.max()), int((d > 1).any(-1).sum())

    @phase("5l lit main path")
    def lit():
        scene_md = load_test_scene()
        r = lit_renderer(scene_md, texture=checker_texture())
        img, depth, counts["k2g"] = drive_lit("test scene (K2g)", r, "k2g")
        rc = lit_renderer(scene_md, texture=checker_texture(), device="cpu")
        img_c, depth_c = rc.render_and_read()
        lsb, over1 = lsb_diff(img, img_c)
        cov_same = np.array_equal(depth < 1.0, depth_c < 1.0)
        print(f"  lit test scene card vs CPU frame: coverage equal "
              f"{cov_same}, max {lsb} LSB, {over1} px over 1 LSB")
        if not cov_same or lsb > LIT_MAX_LSB:
            raise AssertionError("lit 1080p frame differs from the CPU frame")

        md = MeshData.load(os.path.join(SHOWCASE_DIR, "meshes.bin"))
        sc = Scene.load(os.path.join(SHOWCASE_DIR, "scene.bin"))
        textures, mat_tex = textures_from_mesh_data(md, SHOWCASE_DIR)
        if textures is None:
            raise AssertionError("showcase textures did not load")
        rs = lit_renderer((sc, md))
        rs.set_environment(textures=textures, material_textures=mat_tex)
        img_s, _, _ = drive_lit("showcase (K2g, texture array of "
                             f"{rs.texture.num_layers} layers)", rs, "k2g")
        spread = img_s[..., :3].reshape(-1, 3).std(axis=0)
        print(f"  showcase channel spread {spread.round(2).tolist()}")
        if not (spread > 5).all():
            raise AssertionError("showcase: textures not sampled")

        rl = lit_renderer(lattice, texture=checker_texture())
        _, _, counts["k3g"] = drive_lit("lattice20k (K3g)", rl, "k3g")

        r4 = lit_renderer(lattice_big, texture=checker_texture())
        *f4, counts["k4g"] = drive_lit("lattice1M (K4g)", r4, "k4g")
        r5 = lit_renderer(lattice_big, "hierarchy", texture=checker_texture())
        *f5, counts["k5g"] = drive_lit("lattice1M (K5g)", r5, "k5g")
        rows_big = lit_frame_rows(r4)
        # The main path's K4g inputs against the plain version; its time
        # is K4g's plain_ms.
        g4 = compare_gbuffer(
            "k4g", "lit lattice1M", k4g, raster.gbuffer_binned_plain,
            raster.prepare_binned_hbm_inputs(*rows_big, PAD_W, PAD_H),
            PAD_W, PAD_H, plain_shape="lattice1M")
        g4 = [p[:HEIGHT, :WIDTH] for p in g4]
        g5 = [p[:HEIGHT, :WIDTH] for p in raster.rasterize_gbuffer_hbm(
            *rows_big, PAD_W, PAD_H)]
        same = [torch.equal(a.contiguous().view(torch.int32),
                            b.contiguous().view(torch.int32))
                for a, b in zip(g4, g5)]
        same_frame = (np.array_equal(f4[0], f5[0])
                      and np.array_equal(f4[1].view(np.int32),
                                         f5[1].view(np.int32)))
        print(f"  lit lattice1M K4g == K5g: visible G-buffer planes "
              f"{sum(same)}/{len(same)} bitwise equal, frames equal "
              f"{same_frame}")
        if not all(same) or not same_frame:
            raise AssertionError("lattice1M: K4g and K5g differ")

        rg = lit_renderer(make_test_scene(), width=160, height=96,
                          texture=Texture.from_array(checkerboard(64, 8)),
                          tri_align=64)
        img_g, _ = rg.render_and_read()
        lsb, over1 = lsb_diff(img_g, read_png(LIT_GOLDEN))
        print(f"  lit 160x96 vs tests/goldens/lit_160x96.png: max {lsb} LSB,"
              f" {over1} px over 1 LSB")
        if lsb > LIT_MAX_LSB:
            raise AssertionError("lit 160x96 frame differs from the golden")
        return r, rl, r4, r5, rows_big

    r_lit, r_lit3, r_lit4, r_lit5, rows_lit_big = lit or (None,) * 5

    # -- 5s. shadowed main path ---------------------------------------------
    def drive_shadowed(label, r, keys):
        """One shadowed frame through Renderer.render_and_read with every
        launch count set to 0 just before and read just after: one launch
        of each kernel of ``keys`` (depth pass, G-buffer) and no other."""
        for kern in kernel_of.values():
            kern.launches = 0
        t0 = time.perf_counter()
        img, depth = r.render_and_read()
        wall = (time.perf_counter() - t0) * 1000.0
        launched = {k: kern.launches for k, kern in kernel_of.items()}
        shadow = r._shadow_map
        cov = (depth < 1.0).mean()
        cov_map = (shadow < 1.0).float().mean().item()
        print(f"  shadowed {label} {img.shape[1]}x{img.shape[0]} binning="
              f"{r.config.binning}: coverage={cov:.4f}, shadow map "
              f"{tuple(shadow.shape)} coverage={cov_map:.4f}, first frame "
              f"{wall:.1f} ms (host clock, warm-up included), launches "
              f"{ {k: n for k, n in launched.items() if n} }", flush=True)
        if img.shape[:2] != (r.config.height, r.config.width):
            raise AssertionError(f"shadowed {label}: bad frame shape")
        if not np.isfinite(depth).all() or cov <= MIN_COVERAGE:
            raise AssertionError(f"shadowed {label}: frame empty or not "
                                 "finite")
        if not torch.isfinite(shadow).all() or cov_map <= MIN_COVERAGE:
            raise AssertionError(f"shadowed {label}: shadow map empty or "
                                 "not finite")
        if (any(launched[k] != 1 for k in keys)
                or sum(launched.values()) != len(keys)):
            raise AssertionError(f"shadowed {label}: expected one launch of "
                                 f"each of {keys}, got {launched}")
        return img, depth, shadow, {k: launched[k] for k in keys}

    def lit_fraction(r):
        """The PCF lit fraction of a shadowed renderer's current frame, on
        its device, through the frame's own stages (build_shadowed_frame):
        G-buffer, world position, normal, then the lookup in its map."""
        cfg = r.config
        c = {k: torch.from_numpy(v).to(r.device)
             for k, v in r._lit_constants().items()}
        g = passes._gbuffer(r._buffers(), c["matrices"], c["normal_mats"],
                            cfg.width, cfg.height, cfg.pad_height,
                            cfg.pad_width, cfg.binning)
        normal = torch.stack(g[4:7], dim=-1)
        n = normal / torch.clamp_min(shading._norm(normal),
                                     shading._f32(1e-8))
        world = shading.reconstruct_world_pos(g[1], c["inv_view_proj"],
                                              cfg.width, cfg.height)
        return shading.shadow_factor_pcf_strided(
            r._shadow_map, world, c["light_vp"],
            stride=cfg.shadow_lookup_stride, bias=cfg.shadow_bias,
            taps=cfg.pcf_taps, normal=n, light_dir=r._light_dir_dev,
            slope_bias=cfg.shadow_slope_bias)

    def hold_shadowed(label, img, img_ref, covered, frac=None, frac_ref=None):
        """Trouble 3's contract between two shadowed frames: pixels where
        whole PCF taps flip (from the lit fractions when given, else those
        over LIT_MAX_LSB) at most SHADOW_MAX_FLIP_SHARE of the covered
        pixels and at most a tap's TAP_MAX_LSB each; u8 within LIT_MAX_LSB
        on every other pixel.  Returns the flipped-pixel count."""
        diff = np.abs(img.astype(np.int32)
                      - img_ref.astype(np.int32)).max(axis=-1)
        if frac is not None:
            taps = (2 * RenderConfig().pcf_taps + 1) ** 2
            steps = ((frac - frac_ref) * taps).cpu().numpy()
            flipped = steps != 0
            whole = np.abs(steps - np.round(steps)).max() < 1e-3
        else:
            flipped = diff > LIT_MAX_LSB
            whole = True
        n_flip = int(flipped.sum())
        n_cov = int(covered.sum())
        rest = int(diff[~flipped].max()) if (~flipped).any() else 0
        worst = int(diff[flipped].max()) if n_flip else 0
        print(f"  {label}: {n_flip} of {n_cov} covered px with flipped PCF "
              f"taps ({n_flip / max(n_cov, 1):.6f}; whole taps {whole}, max "
              f"{worst} LSB there), max {rest} LSB elsewhere", flush=True)
        if (not whole or n_flip > SHADOW_MAX_FLIP_SHARE * n_cov
                or worst > TAP_MAX_LSB or rest > LIT_MAX_LSB):
            raise AssertionError(f"{label}: outside the shadowed contract")
        return n_flip

    def same_maps(label, a, b):
        """Equal shadow maps by value (the sign of a zero z may differ) and
        bit-equal visible frames."""
        same_map = torch.equal(a[2], b[2])
        same_frame = (np.array_equal(a[0], b[0])
                      and np.array_equal(a[1].view(np.int32),
                                         b[1].view(np.int32)))
        print(f"  {label}: shadow maps equal {same_map}, frames equal "
              f"{same_frame}")
        if not (same_map and same_frame):
            raise AssertionError(f"{label}: shadow maps or frames differ")

    @phase("5s shadowed main path")
    def shadowed():
        S = SHADOW_SIZE
        scene_md = load_test_scene()
        r = shadow_renderer(scene_md)
        img, depth, shadow, n = drive_shadowed("test scene (K2d, K2g)", r,
                                               ("k2d", "k2g"))
        counts["k2d"] = n["k2d"]
        rc = shadow_renderer(scene_md, device="cpu")
        img_c, depth_c = rc.render_and_read()
        cov_same = np.array_equal(depth < 1.0, depth_c < 1.0)
        map_same = torch.equal(shadow.cpu().view(torch.int32),
                               rc._shadow_map.view(torch.int32))
        print(f"  shadowed test scene card vs CPU frame: coverage equal "
              f"{cov_same}, shadow map bit-equal {map_same}")
        if not (cov_same and map_same):
            raise AssertionError("shadowed 1080p frame: coverage or map "
                                 "differs from the CPU's")
        flips = hold_shadowed("shadowed test scene card vs CPU", img, img_c,
                              depth < 1.0, lit_fraction(r).cpu(),
                              lit_fraction(rc))

        r3 = shadow_renderer(lattice)
        f3 = drive_shadowed("lattice20k (K3d, K3g)", r3, ("k3d", "k3g"))
        counts["k3d"] = f3[3]["k3d"]
        r6 = shadow_renderer(lattice, "tile_lists")
        f6 = drive_shadowed("lattice20k (K6d, K6g)", r6, ("k6d", "k6g"))
        counts["k6d"], counts["k6g"] = f6[3]["k6d"], f6[3]["k6g"]
        same_maps("shadowed lattice20k K3d+K3g == K6d+K6g", f3, f6)

        r4 = shadow_renderer(lattice_big)
        f4 = drive_shadowed("lattice1M (K4d, K4g)", r4, ("k4d", "k4g"))
        counts["k4d"] = f4[3]["k4d"]
        r5 = shadow_renderer(lattice_big, "hierarchy")
        f5 = drive_shadowed("lattice1M (K5, K5g)", r5, ("k5", "k5g"))
        same_maps("shadowed lattice1M K4d+K4g == K5+K5g", f4, f5)
        rows_big = light_rows(r4)
        # The main path's K4d inputs against the plain version; its time
        # is K4d's plain_ms.
        compare_depth("k4d", "shadowed lattice1M, light view", k4d,
                      raster.depth_binned_plain,
                      raster.prepare_binned_hbm_inputs(*rows_big, S, S),
                      S, S, plain_shape="lattice1M")

        # The golden's renderer: the default config, its 1024^2 map.
        rg = shadow_renderer(make_test_scene(), width=160, height=96,
                             tri_align=64,
                             shadow_size=RenderConfig().shadow_size)
        img_g, depth_g = rg.render_and_read()
        hold_shadowed("shadowed 160x96 vs tests/goldens/shadowed_160x96.png",
                      img_g, read_png(SHADOWED_GOLDEN), depth_g < 1.0)
        print(f"  launches in the shadowed runs: "
              f"{ {k: counts[k] for k in ('k2d', 'k3d', 'k4d', 'k6d', 'k6g')} }"
              f"; flipped PCF pixels at 1080p: {flips}")
        return r, r3, r6, r4, rows_big

    r_sh, r_sh3, r_sh6, r_sh4, rows_sh_big = shadowed or (None,) * 5
    del lattice_big

    # -- 5dl. deferred main path ---------------------------------------------
    def drive_deferred(label, r, keys):
        """One deferred frame through Renderer.render_and_read with every
        launch count set to 0 just before and read just after: one launch
        of each kernel of ``keys`` (G-buffer, K7) and no other."""
        for kern in kernel_of.values():
            kern.launches = 0
        t0 = time.perf_counter()
        img, depth = r.render_and_read()
        wall = (time.perf_counter() - t0) * 1000.0
        launched = {k: kern.launches for k, kern in kernel_of.items()}
        cov = (depth < 1.0).mean()
        lit = img[depth < 1.0][:, :3].astype(np.float64).mean()
        print(f"  deferred {label} {img.shape[1]}x{img.shape[0]}: coverage="
              f"{cov:.4f}, mean covered u8 {lit:.3f}, first frame {wall:.1f}"
              f" ms (host clock, warm-up included), launches "
              f"{ {k: n for k, n in launched.items() if n} }", flush=True)
        if img.shape[:2] != (r.config.height, r.config.width):
            raise AssertionError(f"deferred {label}: bad frame shape")
        if not np.isfinite(depth).all() or cov <= MIN_COVERAGE or lit <= 0:
            raise AssertionError(f"deferred {label}: frame empty or dark")
        if (any(launched[k] != 1 for k in keys)
                or sum(launched.values()) != len(keys)):
            raise AssertionError(f"deferred {label}: expected one launch of "
                                 f"each of {keys}, got {launched}")
        return img, depth, {k: launched[k] for k in keys}

    @phase("5dl deferred main path")
    def deferred():
        scene_md = load_test_scene()
        runs = {}
        for name in ("wide", "r2"):
            r = deferred_renderer(scene_md, baseline_lights(name))
            img, _, n = drive_deferred(f"test scene, {name} lights (K2g, K7)",
                                       r, ("k2g", "k7"))
            counts["k7"] = n["k7"]
            runs[name] = (r, img)
        rb = deferred_renderer(scene_md, baseline_lights("wide"), "bf16")
        img_b, _, n = drive_deferred("test scene, wide lights, bf16 planes "
                                     "(K2g, K7 bf16)", rb, ("k2g", "k7_bf16"))
        counts["k7_bf16"] = n["k7_bf16"]
        lsb, over1 = lsb_diff(img_b, runs["wide"][1])
        print(f"  bf16 planes vs f32 planes at {WIDTH}x{HEIGHT}: max {lsb} "
              f"LSB, {over1} px over 1 LSB (bf16 world positions move the "
              "lights' 1/d^2 near surfaces)")

        w, h = DEFERRED_CPU_W, DEFERRED_CPU_H
        for name in ("wide", "r2"):
            lights = baseline_lights(name)
            img_d, depth_d = deferred_renderer(
                scene_md, lights, width=w, height=h).render_and_read()
            img_c, depth_c = deferred_renderer(
                scene_md, lights, device="cpu", width=w,
                height=h).render_and_read()
            lsb, over1 = lsb_diff(img_d, img_c)
            cov_same = np.array_equal(depth_d < 1.0, depth_c < 1.0)
            print(f"  deferred {name} {w}x{h} card vs CPU frame: coverage "
                  f"equal {cov_same}, max {lsb} LSB, {over1} px over 1 LSB, "
                  f"equal px {(img_d == img_c).all(-1).mean():.6f}")
            if not cov_same or lsb > LIT_MAX_LSB:
                raise AssertionError(f"deferred {name}: card frame differs "
                                     "from the CPU frame")

        rg = deferred_renderer(make_test_scene(), golden_lights(), width=160,
                               height=96, tri_align=64)
        img_g, _ = rg.render_and_read()
        lsb, over1 = lsb_diff(img_g, read_png(DEFERRED_GOLDEN))
        print(f"  deferred 160x96 vs tests/goldens/deferred_160x96.png: max "
              f"{lsb} LSB, {over1} px over 1 LSB")
        if lsb > LIT_MAX_LSB:
            raise AssertionError("deferred 160x96 frame differs from the "
                                 "golden")
        return runs["wide"][0], runs["r2"][0], rb

    r_def, r_def_r2, r_def_bf16 = deferred or (None,) * 3

    # -- 5t. TAA ------------------------------------------------------------
    @phase("5t TAA")
    def taa_checks():
        b = r_scene._buffers()
        jitters = taa.jitter_sequence(8)
        hist = hist_p = hist_c = None
        for j in jitters:
            mats = torch.from_numpy(r_scene.camera_matrices(jitter=j)).to(dev)
            packed, _ = raster.render_frame(b["corner_cols"], b["tri_node"],
                                            mats, WIDTH, HEIGHT, PAD_H, PAD_W)
            frame = raster.unpack_rgba8(packed)
            if hist is None:
                hist = taa.taa_init_history(frame)
                hist_p = taa.taa_init_history_packed(packed)
                hist_c = taa.taa_init_history(frame.cpu())
            hist, res = taa.taa_resolve(hist, frame)
            hist_p, res_p = taa.taa_resolve_packed(hist_p, packed)
            hist_c, res_c = taa.taa_resolve(hist_c, frame.cpu())
            same = (torch.equal(hist.cpu(), hist_c)
                    and torch.equal(res.cpu(), res_c)
                    and torch.equal(hist_p.permute(1, 2, 0), hist)
                    and torch.equal(raster.unpack_rgba8(res_p), res))
            if not same:
                raise AssertionError("TAA resolves differ (card u8, card "
                                     "packed, CPU)")
        moved = (res[..., :3] != frame[..., :3]).any(-1).float().mean().item()
        print(f"  taa_resolve == taa_resolve_packed on the card == "
              f"taa_resolve on the CPU over 8 jittered {WIDTH}x{HEIGHT} "
              f"frames; the last resolved frame differs from its input on "
              f"{moved:.4f} of the pixels")

        rg = Renderer(RenderConfig(width=160, height=96, tri_align=64),
                      device=DEVICE)
        rg.load_scene(*make_test_scene())
        hist = None
        for j in jitters:
            color, _ = rg.render(jitter=j)
            if hist is None:
                hist = taa.taa_init_history(color)
            hist, resolved = taa.taa_resolve(hist, color)
        same = np.array_equal(resolved.cpu().numpy(), read_png(TAA_GOLDEN))
        print(f"  TAA 160x96 vs tests/goldens/taa_converged_160x96.png: "
              f"bit-equal {same}")
        if not same:
            raise AssertionError("TAA 160x96 frame differs from the golden")

        for kern in kernel_of.values():
            kern.launches = 0
        acc, prev, hist, resolved, packed = config4(r_k4, CONFIG4_FRAMES)
        launched = {k: kern.launches for k, kern in kernel_of.items() if
                    kern.launches}
        _, check = taa.taa_resolve(prev.permute(1, 2, 0),
                                   raster.unpack_rgba8(packed))
        same = torch.equal(raster.unpack_rgba8(resolved), check)
        cov = (raster.unpack_rgba8(resolved)[..., :3].sum(-1) > 0).float()
        print(f"  config 4 (lattice1M, K4 + taa_resolve_packed, "
              f"{CONFIG4_FRAMES} jittered frames): digest {acc.item():.6e}, "
              f"coverage {cov.mean().item():.4f}, last resolve == "
              f"taa_resolve {same}, launches {launched}")
        if (launched != {"k4": CONFIG4_FRAMES + 1} or not same
                or not torch.isfinite(acc) or cov.mean().item() <= MIN_COVERAGE
                or int(hist.min()) < 0 or int(hist.max()) > taa.FIXED_MAX):
            raise AssertionError("config 4 did not render through K4 + TAA")

    # -- 5o. overlay main path ---------------------------------------------
    def overlay_frames(r, ui_o, ui_i, lines):
        """The app's overlay frames on the flat renderer ``r``: one frame
        through OverlayUI.compose (--overlay), one through
        ImguiOverlay.compose (--ui), each composited on the card and read
        back.  Returns the two host frames."""
        color, _ = r.render()
        out_o = ui_o.compose(color, lines)
        color, _ = r.render()
        out_i = ui_i.compose(color, stats_text, r.scene)
        return out_o, out_i

    @phase("5o overlay main path")
    def overlay_main():
        scene = r_scene.scene
        lines = ui_lines(scene)
        ui_o = OverlayUI(WIDTH, HEIGHT, device=DEVICE)
        ui_i = ImguiOverlay(WIDTH, HEIGHT, device=DEVICE)
        for kern in kernel_of.values():
            kern.launches = 0
        out_o, out_i = overlay_frames(r_scene, ui_o, ui_i, lines)
        launched = {k: kern.launches for k, kern in kernel_of.items()
                    if kern.launches}
        print(f"  test scene {WIDTH}x{HEIGHT}, one --overlay frame and one "
              f"--ui frame: launches {launched}")
        if launched != {"k1": 2, "k8": 2, "k8b": 2}:
            raise AssertionError("each overlay frame must launch K1, K8 and "
                                 "K8b once")
        counts["k8"], counts["k8b"] = launched["k8"], launched["k8b"]

        img, _ = r_scene.read_frame()
        cpu = {"--overlay": (OverlayUI(WIDTH, HEIGHT, device="cpu"),
                             lambda ui: ui.draw_list(lines),
                             lambda ui: ui.compose(img, lines), out_o),
               "--ui": (ImguiOverlay(WIDTH, HEIGHT, device="cpu"),
                        lambda ui: ui.draw_list(stats_text, scene),
                        lambda ui: ui.compose(img, stats_text, scene), out_i)}
        for name, (ui, draw, compose, out) in cpu.items():
            ref = compose(ui)
            rows = overlay_rows(draw(ui), "cpu")
            cnt_c, over_c, _ = overlay.rasterize_overlay(*rows, WIDTH, HEIGHT)
            cnt_d, over_d, _ = overlay.rasterize_overlay(
                *(x.to(dev) for x in rows), WIDTH, HEIGHT)
            same_cnt = (torch.equal(cnt_d.cpu(), cnt_c)
                        and torch.equal(over_d.cpu(), over_c))
            lsb, over1 = lsb_diff(out, ref)
            ui_share = (out[..., :3] != img[..., :3]).any(-1).mean()
            print(f"  {name} frame, card vs the port's CPU composite: count "
                  f"and overflow equal {same_cnt}, max {lsb} LSB, "
                  f"{over1} px over 1 LSB, equal px "
                  f"{(out == ref).all(-1).mean():.6f}, max count "
                  f"{int(cnt_c.max().item())}, UI pixels {ui_share:.4f}")
            if not same_cnt or lsb > OVERLAY_MAX_LSB:
                raise AssertionError(f"{name}: card frame differs from the "
                                     "CPU composite")
            if ui_share <= 0.001:
                raise AssertionError(f"{name}: no UI on the frame")

        rg = Renderer(RenderConfig(width=160, height=96, tri_align=64),
                      device=DEVICE)
        rg.load_scene(*make_test_scene())
        img_g, _ = rg.render_and_read()
        out_g = OverlayUI(160, 96, device=DEVICE).compose(
            img_g, ["zrenderer-tpu golden", "nodes: Cube, Cube.002"])
        lsb, _ = lsb_diff(out_g, read_png(OVERLAY_GOLDEN))
        print(f"  overlay 160x96 vs tests/goldens/overlay_160x96.png: max "
              f"{lsb} LSB, "
              f"{int((out_g != read_png(OVERLAY_GOLDEN)).any(-1).sum())} px "
              "differ")
        if lsb > OVERLAY_MAX_LSB:
            raise AssertionError("overlay 160x96 frame differs from the "
                                 "golden")
        return ui_o, ui_i, lines

    ui_o, ui_i, ui_text = overlay_main or (None,) * 3

    # -- 6. timing --------------------------------------------------------
    # A trace can hold a launch call without its kernel record, rarely
    # after a few untraced launches and in every trace after a million of
    # them (zrenderer_tpu_torch/tools/profiler_probe.py).  So every trace
    # comes before the untraced timing loops, and a kernel is timed only
    # from a trace that holds every one of its launches.
    def event_ms(fn, reps):
        """Time per call from CUDA events around ``reps`` back-to-back
        calls: device time where the device is the bottleneck, host
        dispatch time where the host is."""
        fn()
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    # Kernel names in the profiler's trace.
    kernel_names = {"k1": "raster_small_kernel",
                    "k3": "raster_hier_keyed_kernel",
                    "k4": "raster_records_kernel",
                    "k4_coarse": "raster_records_coarse_keyed_kernel",
                    "k5": "raster_hbm_keyed_kernel",
                    "k6": "raster_lists_keyed_kernel",
                    "k2g": "gbuffer_small_kernel",
                    "k3g": "gbuffer_hier_keyed_kernel",
                    "k4g": "gbuffer_records_keyed_kernel",
                    "k5g": "gbuffer_hbm_keyed_kernel",
                    "k6g": "gbuffer_lists_keyed_kernel",
                    "k2d": "depth_small_kernel",
                    "k3d": "depth_hier_keyed_kernel",
                    "k4d": "depth_records_kernel",
                    "k6d": "depth_lists_keyed_kernel",
                    "k7": "light_tiled_kernel<float,",
                    "k7_bf16": "light_tiled_kernel<__nv_bfloat16,",
                    "k8": "overlay_raster_kernel<8>",
                    "k8b": "overlay_composite_kernel",
                    "k3b": "raster_hier_band_keyed_kernel",
                    "k9": "raster_records_band_keyed_kernel",
                    "k9g": "gbuffer_records_band_kernel",
                    "k9d": "raster_records_dist_keyed_kernel",
                    "k10g8": "raster_group8_keyed_kernel",
                    "k10g8g": "gbuffer_group8_keyed_kernel",
                    "k10g8d": "depth_group8_keyed_kernel",
                    "k10vec": "raster_vec_keyed_kernel",
                    "k10vecg": "gbuffer_vec_keyed_kernel",
                    "k10vis": "raster_vis_keyed_kernel",
                    "k10trans": "raster_trans_keyed_kernel",
                    "k10hbm2": "raster_hbm2_keyed_kernel",
                    "k10scan": "raster_scan_keyed_kernel"}
    # K4, K4c, K4g, K4d, K6, K6g, K6d, K9 and K9d make three device
    # operations a call: the key plane's memset, the item kernel
    # (kernel_names) and the resolve kernel.
    resolve_names = {"k4": "raster_records_resolve_kernel",
                     "k4_coarse": "raster_records_coarse_resolve_kernel",
                     "k4g": "gbuffer_records_resolve_kernel",
                     "k4d": "depth_records_resolve_kernel",
                     "k6": "raster_lists_resolve_kernel",
                     "k6g": "gbuffer_lists_resolve_kernel",
                     "k6d": "depth_lists_resolve_kernel",
                     "k9": "raster_records_band_resolve_kernel",
                     "k9d": "raster_records_dist_resolve_kernel"}
    # K3, K3b, K3g, K3d, K5 and K5g, with more than one work item a tile
    # (raster.HIER_ITEMS), issue the same three; with one, the item kernel
    # alone.
    hier_resolve_names = {"k3": "raster_hier_resolve_kernel",
                          "k3b": "raster_hier_band_resolve_kernel",
                          "k3g": "gbuffer_hier_resolve_kernel",
                          "k3d": "depth_hier_resolve_kernel",
                          "k5": "raster_hbm_resolve_kernel",
                          "k5g": "gbuffer_hbm_resolve_kernel"}
    # K10hbm2 and K10scan likewise, with hbm2.TWOCLASS_ITEMS, and K10vis
    # and K10trans with vis_trans.VIS_ITEMS.
    twoclass_resolve_names = {"k10hbm2": "raster_hbm2_resolve_kernel",
                              "k10scan": "raster_scan_resolve_kernel"}
    vis_resolve_names = {"k10vis": "raster_vis_resolve_kernel",
                         "k10trans": "raster_trans_resolve_kernel"}
    # K10vec and K10vecg likewise, with vec.VEC_ITEMS, and K10g8, K10g8g
    # and K10g8d with group8.G8_ITEMS.
    x_resolve_names = {"k10vec": "raster_vec_resolve_kernel",
                       "k10vecg": "gbuffer_vec_resolve_kernel",
                       "k10g8": "raster_group8_resolve_kernel",
                       "k10g8g": "gbuffer_group8_resolve_kernel",
                       "k10g8d": "depth_group8_resolve_kernel"}

    def x_items(key):
        """Work items a tile of K10vec, K10vecg, K10g8, K10g8g or K10g8d,
        as read at call time."""
        return (vec.VEC_ITEMS if key.startswith("k10vec")
                else group8.G8_ITEMS)

    def at_x_items(key, n, fn):
        """``fn()`` with the work items a tile of K10vec and K10vecg, or of
        K10g8, K10g8g and K10g8d, set to n."""
        mod, attr = ((vec, "VEC_ITEMS") if key.startswith("k10vec")
                     else (group8, "G8_ITEMS"))
        saved = getattr(mod, attr)
        setattr(mod, attr, n)
        try:
            return fn()
        finally:
            setattr(mod, attr, saved)
    # The hierarchy kernels first write the tiles' hit words: one more
    # device operation a call, before the others (the two-class kernels
    # both views' in one launch; K10vis from its bitmap).
    HIT_WORDS_KERNEL = "hier_hit_words_kernel"
    TWOCLASS_HIT_WORDS_KERNEL = "twoclass_hit_words_kernel"
    hit_words_names = {
        **{k: HIT_WORDS_KERNEL for k in hier_resolve_names},
        **{k: TWOCLASS_HIT_WORDS_KERNEL for k in twoclass_resolve_names},
        "k10vis": "vis_hit_words_kernel",
        "k10trans": "trans_hit_words_kernel",
        "k10vec": "vec_hit_words_kernel",
        "k10vecg": "vec_hit_words_kernel",
        "k10g8": "group8_hit_words_kernel",
        "k10g8g": "group8_hit_words_kernel",
        "k10g8d": "group8_hit_words_kernel"}
    port_kernels = (set(kernel_names.values()) | set(resolve_names.values())
                    | set(hier_resolve_names.values())
                    | set(twoclass_resolve_names.values())
                    | set(vis_resolve_names.values())
                    | set(x_resolve_names.values())
                    | set(hit_words_names.values()))

    def resolve_of(key):
        """The resolve kernel of a call of kernel ``key``, or None for a
        call without one."""
        if key in hier_resolve_names and raster.HIER_ITEMS > 1:
            return hier_resolve_names[key]
        if key in twoclass_resolve_names and hbm2.TWOCLASS_ITEMS > 1:
            return twoclass_resolve_names[key]
        if key in vis_resolve_names and vis_trans.VIS_ITEMS > 1:
            return vis_resolve_names[key]
        if key in x_resolve_names and x_items(key) > 1:
            return x_resolve_names[key]
        return resolve_names.get(key)

    def call_ops(key):
        """The device operations of a call of kernel ``key``, in order:
        the hierarchy kernels' hit words, the key plane's memset where a
        resolve follows, the item kernel (kernel_names), the resolve."""
        resolve = resolve_of(key)
        ops = [hit_words_names[key]] if key in hit_words_names else []
        ops += ["Memset"] if resolve else []
        return ops + [kernel_names[key]] + ([resolve] if resolve else [])

    def call_durations(key, events):
        """Device us of each call of kernel ``key`` in a trace's events:
        the sum of its ``call_ops``, adjacent in time order (for K1 its
        kernel alone; for K4/K4c/K4g/K4d/K6/K6g/K6d/K9/K9d, the memset, the
        item kernel and the resolve kernel; for K3/K3b/K3g/K3d/K5/K5g the hit
        words' kernel, then the item kernel between the memset and the
        resolve with several items a tile; for K10hbm2 and K10scan the
        same with their own hit words' kernel).  A call without all of them
        counts as no call, so the trace reads short."""
        ops = call_ops(key)
        if len(ops) == 1:
            return [d for n, _, d in events if ops[0] in n]
        ev = sorted(events, key=lambda e: e[1])
        k = ops.index(kernel_names[key])
        out = []
        for i, (n, _, d) in enumerate(ev):
            run = ev[i - k:i - k + len(ops)] if i >= k else []
            if (ops[k] in n and len(run) == len(ops)
                    and all(o in e[0] for o, e in zip(ops, run))):
                out.append(sum(e[2] for e in run))
        return out

    def traced_kernel_ms(keys, fn, attempts=3):
        """Device events of ``fn``'s traced run, its window, and the mean
        duration (ms) of each kernel of ``keys`` in it, from the first of
        ``attempts`` traces that holds every launch of each (half the
        launches counted over warm-up and trace); raises if none does."""
        for attempt in range(1, attempts + 1):
            before = {k: kernel_of[k].launches for k in keys}
            events, window = device_trace(fn)
            ms, short = {}, []
            for k in keys:
                launched = (kernel_of[k].launches - before[k]) // 2
                durs = call_durations(k, events)
                if launched > 0 and len(durs) == launched:
                    ms[k] = sum(durs) / len(durs) / 1000.0
                else:
                    short.append(f"{k} {len(durs)} of {launched}")
            if not short:
                return events, window, ms
            print(f"  trace {attempt} holds {', '.join(short)} launches",
                  flush=True)
        raise AssertionError(f"{keys}: no trace of {attempts} held every "
                             "launch")

    def lit_stages():
        """The lit 1080p test-scene frame split into its stages, each a
        callable on the previous stage's outputs: {name: (fn, reps)}."""
        r = r_lit
        b = r._buffers()
        c = {k: torch.from_numpy(v).to(dev)
             for k, v in r._lit_constants().items()}
        tex = r.texture
        th, tw = tex.base_shape
        levels = tex.num_levels

        def geometry():
            return tg.geometry_pipeline_cols(
                b["corner_cols"], b["tri_node"], c["matrices"], WIDTH,
                HEIGHT, normal_matrices=c["normal_mats"],
                material_table=b["materials"])

        ti, tf = geometry()
        prep = raster.prepare_binned_small(ti, tf, PAD_W, PAD_H)
        planes = k2g(*prep, PAD_W, PAD_H)

        def crop():
            return ([raster.unpack_rgba8(planes[0][:HEIGHT, :WIDTH])]
                    + [p[:HEIGHT, :WIDTH] for p in planes[1:]])

        g = crop()
        uv = torch.stack([g[2], g[3]], dim=-1)

        def lod():
            return sampling.mip_level_from_derivatives(
                torch.stack([g[2], g[3]], dim=-1), th, tw, levels)

        level = lod()

        def sample():
            return sampling.sample_trilinear(tex.atlas_u32, th, tw, levels,
                                             uv, level)

        texel = sample()
        albedo = (g[0][..., :3].to(torch.float32)
                  / shading._const(texel, 255.0)) * texel[..., :3]

        def shade():
            world = shading.reconstruct_world_pos(g[1], c["inv_view_proj"],
                                                  WIDTH, HEIGHT)
            spec, shin = shading.blinn_params_from_material(g[7], g[8])
            lit_rgb = shading.blinn_phong(
                albedo, torch.stack(g[4:7], dim=-1), world, c["cam_pos"],
                r.light_pos, r.light_color, specular=spec, shininess=shin)
            lit_rgb = lit_rgb + torch.stack(g[9:12], dim=-1)
            return shading.tonemap_and_pack(lit_rgb, g[1] < 1.0)

        color = shade()
        return {
            "lit geometry": (geometry, 50),
            "lit prepare_binned_small": (lambda: raster.prepare_binned_small(
                ti, tf, PAD_W, PAD_H), 50),
            "lit K2g launcher": (lambda: k2g(*prep, PAD_W, PAD_H), 50),
            "lit crop": (crop, 50),
            "lit LOD": (lod, 50),
            "lit sampling": (sample, 50),
            "lit shading + tonemap": (shade, 50),
            "lit digest": (lambda: rgba_digest(color), 50),
            "lit whole frame (passes.build_lit_frame)": (
                lambda: r._frame_fn()(b, tex.atlas_u32, c["matrices"],
                                      c["normal_mats"], c["inv_view_proj"],
                                      c["cam_pos"], r.light_pos,
                                      r.light_color), 50),
        }

    def shadow_stages():
        """The shadowed 1080p test-scene frame (BASELINE config 2: the
        default 1x1 white texture, a 1024^2 map) split into its stages as
        in ``lit_stages``."""
        r = r_sh
        cfg = r.config
        S = cfg.shadow_size
        b = r._buffers()
        c = {k: torch.from_numpy(v).to(dev)
             for k, v in r._lit_constants().items()}
        tex = r.texture
        th, tw = tex.base_shape

        def depth_geometry():
            return tg.geometry_pipeline_cols(
                b["corner_cols"], b["tri_node"], c["light_matrices"], S, S)

        dti, dtf = depth_geometry()
        dprep = raster.prepare_binned_small(dti, dtf, S, S)
        shadow = k2d(*dprep, S, S)

        def geometry():
            return tg.geometry_pipeline_cols(
                b["corner_cols"], b["tri_node"], c["matrices"], WIDTH,
                HEIGHT, normal_matrices=c["normal_mats"],
                material_table=b["materials"])

        ti, tf = geometry()
        prep = raster.prepare_binned_small(ti, tf, PAD_W, PAD_H)
        planes = k2g(*prep, PAD_W, PAD_H)

        def crop():
            return ([raster.unpack_rgba8(planes[0][:HEIGHT, :WIDTH])]
                    + [p[:HEIGHT, :WIDTH] for p in planes[1:]])

        g = crop()
        normal = torch.stack(g[4:7], dim=-1)
        n = normal / torch.clamp_min(shading._norm(normal),
                                     shading._f32(1e-8))

        def sample():
            return passes._sample_albedo(g[0], tex.atlas_u32, g[2], g[3],
                                         g[12], th, tw, tex.num_levels,
                                         tex.num_layers > 1)

        albedo = sample()

        def pcf():
            world = shading.reconstruct_world_pos(g[1], c["inv_view_proj"],
                                                  WIDTH, HEIGHT)
            return shading.shadow_factor_pcf_strided(
                shadow, world, c["light_vp"],
                stride=cfg.shadow_lookup_stride, bias=cfg.shadow_bias,
                taps=cfg.pcf_taps, normal=n, light_dir=r._light_dir_dev,
                slope_bias=cfg.shadow_slope_bias)

        lit_mask = pcf()

        def shade():
            ndotl = torch.clamp_min(shading._dot(n, -r._light_dir_dev), 0.0)
            rgb = albedo * (shading._f32(0.10)
                            + ndotl * lit_mask[..., None] * r.light_color)
            rgb = rgb + torch.stack(g[9:12], dim=-1)
            return shading.tonemap_and_pack(rgb, g[1] < 1.0)

        color = shade()
        return {
            "shadowed depth geometry": (depth_geometry, 50),
            "shadowed depth prepare_binned_small": (
                lambda: raster.prepare_binned_small(dti, dtf, S, S), 50),
            "shadowed K2d launcher": (lambda: k2d(*dprep, S, S), 50),
            "shadowed geometry": (geometry, 50),
            "shadowed prepare_binned_small": (
                lambda: raster.prepare_binned_small(ti, tf, PAD_W, PAD_H), 50),
            "shadowed K2g launcher": (lambda: k2g(*prep, PAD_W, PAD_H), 50),
            "shadowed crop": (crop, 50),
            "shadowed sampling": (sample, 50),
            "shadowed PCF (world position + lookup)": (pcf, 50),
            "shadowed shading + tonemap": (shade, 50),
            "shadowed digest": (lambda: rgba_digest(color), 50),
            "shadowed whole frame (passes.build_shadowed_frame)": (
                lambda: r._frame_fn()(b, tex.atlas_u32, c["matrices"],
                                      c["normal_mats"], c["inv_view_proj"],
                                      c["cam_pos"], c["light_matrices"],
                                      c["light_vp"], r._light_dir_dev,
                                      r.light_color), 50),
        }

    def deferred_stages():
        """The deferred 1080p test-scene frame (BASELINE config 3, wide
        lights) split into its stages as in ``lit_stages``."""
        r = r_def
        cfg = r.config
        b = r._buffers()
        c = {k: torch.from_numpy(v).to(dev)
             for k, v in r._lit_constants().items()}

        def geometry():
            return tg.geometry_pipeline_cols(
                b["corner_cols"], b["tri_node"], c["matrices"], WIDTH,
                HEIGHT, normal_matrices=c["normal_mats"],
                material_table=b["materials"])

        ti, tf = geometry()
        prep = raster.prepare_binned_small(ti, tf, PAD_W, PAD_H)
        planes = k2g(*prep, PAD_W, PAD_H)

        def crop():
            return ([raster.unpack_rgba8(planes[0][:HEIGHT, :WIDTH])]
                    + [p[:HEIGHT, :WIDTH] for p in planes[1:]])

        g = crop()

        def world():
            return shading.reconstruct_world_pos(g[1], c["inv_view_proj"],
                                                 WIDTH, HEIGHT)

        wpos = world()

        def prepass():
            return passes.deferred_light_inputs(
                g, wpos, c["cam_pos"], c["view_proj"], *r.lights, WIDTH,
                HEIGHT, PAD_H, PAD_W)

        inputs = prepass()
        out = k7(*inputs)

        def tonemap():
            rgb = out.permute(1, 2, 0)[:HEIGHT, :WIDTH] + torch.stack(
                g[9:12], dim=-1)
            return shading.tonemap_and_pack(rgb, g[1] < 1.0)

        color = tonemap()
        return {
            "deferred geometry": (geometry, 50),
            "deferred prepare_binned_small": (
                lambda: raster.prepare_binned_small(ti, tf, PAD_W, PAD_H), 50),
            "deferred K2g launcher": (lambda: k2g(*prep, PAD_W, PAD_H), 50),
            "deferred crop": (crop, 50),
            "deferred world position": (world, 50),
            "deferred K7 prepass (albedo, pad, planes, light bounds)": (
                prepass, 50),
            "deferred K7 launcher": (lambda: k7(*inputs), 20),
            "deferred emissive + tonemap": (tonemap, 50),
            "deferred digest": (lambda: rgba_digest(color), 50),
            "deferred whole frame (passes.build_deferred_frame)": (
                lambda: r._frame_fn()(b, c["matrices"], c["normal_mats"],
                                      c["inv_view_proj"], c["cam_pos"],
                                      c["view_proj"], *r.lights), 20),
        }

    # -- 4s. band kernels vs plain ------------------------------------------
    # The sharded frames render at a tile-aligned height: 1088 rows split
    # into 2 bands of 544, 1024 rows into 4 bands of 256.
    H2, H4 = 1088, 1024

    def indexed_args(r, height, jitter=None):
        """A renderer's indexed buffers on the card and its per-draw
        matrices at (WIDTH, height): the sharded frames' inputs."""
        b = r._buffers()
        vp = tg.view_proj_from_camera(r.scene.active_camera, WIDTH, height)
        if jitter is not None:
            vp = taa.jittered_view_proj(vp, jitter, WIDTH, height)
        mats = np.einsum("nij,jk->nik", r.flat.node_to_world,
                         vp).astype(np.float32)
        return (b["positions"], b["attrs"], b["tri_vidx"],
                torch.from_numpy(mats).to(dev), b["vert_node"])

    def scene_args(scene_md, height, tri_align=64, lit=False, seed=0):
        """A scene's indexed buffers on the card at (WIDTH, height); with
        ``lit`` random per-draw normal matrices and a random per-triangle
        material table (seeded)."""
        flat = flatten_scene(*scene_md, pad=True, tri_align=tri_align)
        b = flat_scene_to_device(flat.host_arrays(), dev)
        vp = tg.view_proj_from_camera(scene_md[0].active_camera, WIDTH,
                                      height)
        mats = np.einsum("nij,jk->nik", flat.node_to_world,
                         vp).astype(np.float32)
        args = (b["positions"], b["attrs"], b["tri_vidx"],
                torch.from_numpy(mats).to(dev), b["vert_node"])
        if not lit:
            return args, {}
        rng = np.random.default_rng(seed)
        nm = rng.standard_normal((len(mats), 3, 3)).astype(np.float32)
        table = rng.random((len(flat.tri_vidx), tg.MATERIAL_COLS),
                           dtype=np.float32)
        return args, dict(normal_matrices=torch.from_numpy(nm).to(dev),
                          material_table=torch.from_numpy(table).to(dev))

    def band_pairs(ti, row0, band_h):
        """(tile, triangle) pairs of one band: tile_pairs over the band's
        rows of the frame."""
        shifted = ti.clone()
        for c in (tg.I_IMIN, tg.I_IMAX):
            shifted[:, c] = ti[:, c] - row0
        return tile_pairs(shifted, PAD_W, band_h)

    def dist_received(locals_, h, n, s, slab=None):
        """Every band's (listed, rec_i, rec_f, offs) as the all-to-all of
        ``binning="dist"`` delivers them, its ranks in turn."""
        return tiles.dist_exchange(tiles.InTurnExchange(n), locals_, PAD_W,
                                   h, s, slab_records=slab)

    def deferred_args(name):
        """The deferred test scene at (WIDTH, H2) with BASELINE's ``name``
        lights: (renderer, its sharded deferred frame's inputs on the
        card)."""
        rd = deferred_renderer(load_test_scene(), baseline_lights(name),
                               height=H2)
        c = {k: torch.from_numpy(v).to(dev)
             for k, v in rd._lit_constants().items()}
        b = rd._buffers()
        return rd, (b["positions"], b["attrs"], b["tri_vidx"],
                    c["matrices"], b["vert_node"], c["normal_mats"],
                    b["materials"], c["inv_view_proj"], c["cam_pos"],
                    *(torch.as_tensor(x).to(dev) for x in rd.lights),
                    c["view_proj"])

    def band_fn(fn, row0, *extra):
        """``fn(*prepared, w, band_h)`` -> ``fn(..., row0, *extra)``."""
        return lambda *a: fn(*a, row0, *extra)

    def compare_k9(label, prep, row0, band_h, local, plain_shape=None):
        """K9 against its plain version at ITEM_RECORDS records an item,
        then at KEYED_SMALL_ITEMS, whose planes must equal the first's
        bit for bit."""
        ck, dk = compare("k9", f"{label} (K9, band_local={local})",
                         band_fn(k9, row0, local),
                         band_fn(raster.raster_binned_band_plain, row0,
                                 local), prep, PAD_W, band_h,
                         plain_shape=plain_shape)
        cs, ds = with_items(k9, KEYED_SMALL_ITEMS)(*prep, PAD_W, band_h,
                                                   row0, local)
        sync()
        same = (torch.equal(cs, ck) and torch.equal(ds.view(torch.int32),
                                                    dk.view(torch.int32)))
        tiles_x = PAD_W // raster.TILE_W
        base = 0 if local else row0 // raster.TILE_H * tiles_x
        items = raster.keyed_work_items(
            prep[0][base:base + band_h // raster.TILE_H * tiles_x + 1],
            KEYED_SMALL_ITEMS, prep[3].shape[0])
        print(f"    items of {KEYED_SMALL_ITEMS} (at most "
              f"{int(items[:, 2].max().item())} a tile): bit-exact {same}",
              flush=True)
        if not same:
            raise AssertionError(f"{label}: K9 at {KEYED_SMALL_ITEMS} "
                                 "records an item differs")

    def compare_k9d(label, prep, row0, band_h, plain_shape=None):
        """K9d against its plain version at the defaults (ITEM_RECORDS,
        halved while under KEYED_MIN_ITEMS items), then at ITEM_RECORDS
        never halved and at KEYED_SMALL_ITEMS, whose planes must equal the
        first's bit for bit; prints for each the item size, the launch's
        blocks (``raster.keyed_items`` over the slabs' rows), those past
        the kernel's bound from the spans' ends (csrc/raster_binned.cu
        item_bound; they return before the scan), those that find no item
        and the items."""
        ck, dk = compare("k9d", f"{label} (K9d)", band_fn(k9d, row0),
                         band_fn(raster.raster_binned_band_plain, row0),
                         prep, PAD_W, band_h, plain_shape=plain_shape)
        offsets = prep[0]
        n_tiles = offsets.shape[1] - 1
        used = int((offsets[:, -1] - offsets[:, 0]).sum().item())
        for item, min_items in ((raster.ITEM_RECORDS, None),
                                (raster.ITEM_RECORDS, 0),
                                (KEYED_SMALL_ITEMS, None)):
            mi = raster.KEYED_MIN_ITEMS if min_items is None else min_items
            size, items = keyed_table(offsets, item, prep[3].shape[0],
                                      n_tiles, min_items=mi)
            blocks = raster.keyed_items(PAD_W, band_h, prep[1].shape[0],
                                        item, 0, mi)
            bound = n_tiles + used // size
            same = True
            if min_items is not None or item != raster.ITEM_RECORDS:
                cs, ds = with_items(k9d, item, min_items)(*prep, PAD_W,
                                                          band_h, row0)
                sync()
                same = (torch.equal(cs, ck) and torch.equal(
                    ds.view(torch.int32), dk.view(torch.int32)))
            print(f"    at {item} records an item, {mi} items aimed at: "
                  f"items of {size} records; {offsets.shape[0]} sources, "
                  f"{used} span records of {prep[1].shape[0]} slab rows; "
                  f"{blocks} blocks launched, {max(blocks - bound, 0)} past "
                  f"the spans' bound, {min(bound, blocks) - items.shape[0]} "
                  f"more find no item, {items.shape[0]} items (at most "
                  f"{int(items[:, 2].max().item())} a tile); equal to the "
                  f"defaults' planes {same}", flush=True)
            if not same:
                raise AssertionError(f"{label}: K9d at {item} records an "
                                     f"item, {mi} aimed at, differs")

    # -- 5a. assets: runtime glTF, image containers, samplers ----------------
    def container_bytes(rgba, ext):
        """An RGBA8 image as one uncompressed file of the container ``ext``
        (dds, bmp, tga, ppm, tif), written with numpy alone."""
        h, w = rgba.shape[:2]
        if ext == "dds":
            head = bytearray(128)
            head[:4] = b"DDS "
            struct.pack_into("<5I", head, 4, 124, 0x1007, h, w, 0)
            struct.pack_into("<7I", head, 76, 32, 0x41, 0, 32, 0x00FF0000,
                             0x0000FF00, 0x000000FF)
            struct.pack_into("<I", head, 104, 0xFF000000)
            return bytes(head) + rgba[..., [2, 1, 0, 3]].tobytes()
        if ext == "bmp":  # 32 bpp BGRA, top-down
            return (b"BM" + struct.pack("<IHHI", 54 + rgba.size, 0, 0, 54)
                    + struct.pack("<IiiHHIIiiII", 40, w, -h, 1, 32, 0,
                                  rgba.size, 0, 0, 0, 0)
                    + rgba[..., [2, 1, 0, 3]].tobytes())
        if ext == "tga":  # type 2, 32 bpp BGRA, top-left origin
            head = bytearray(18)
            head[2], head[16], head[17] = 2, 32, 0x20
            head[12:16] = struct.pack("<HH", w, h)
            return bytes(head) + rgba[..., [2, 1, 0, 3]].tobytes()
        if ext == "ppm":  # P6: RGB, alpha 255 on decode
            return f"P6\n{w} {h}\n255\n".encode() + rgba[..., :3].tobytes()
        if ext == "tif":  # little-endian, one uncompressed RGBA strip
            tags = ((256, w), (257, h), (262, 2), (273, 0), (277, 4),
                    (278, h), (279, rgba.size))
            data_off = 8 + 2 + 12 * len(tags) + 4
            out = b"II" + struct.pack("<HIH", 42, 8, len(tags))
            for tag, v in tags:
                out += struct.pack("<HHII", tag, 4, 1,
                                   data_off if tag == 273 else v)
            return out + struct.pack("<I", 0) + rgba.tobytes()
        raise ValueError(ext)

    @phase("5a assets: runtime glTF, image containers, samplers")
    def assets():
        if not native.available():
            raise AssertionError("libzrt did not build or load: the "
                                 "converter would run its Python fallbacks")
        print(f"  libzrt {native._lib_path()} (version "
              f"{native.load().zrt_version()})")
        load_ms = {}
        for optimize in (False, True):
            t0 = time.perf_counter()
            loaded = load_gltf(SHOWCASE_GLTF, optimize=optimize)
            load_ms[optimize] = (time.perf_counter() - t0) * 1000.0
            if optimize:
                scene_o, md_o = loaded
            else:
                scene_d, md_d = loaded
        bins = (Scene.load(os.path.join(SHOWCASE_DIR, "scene.bin")),
                MeshData.load(os.path.join(SHOWCASE_DIR, "meshes.bin")))
        same_bins = (scene_o.serialize() == bins[0].serialize()
                     and md_o.serialize() == bins[1].serialize())
        print(f"  runtime glTF load of showcase.gltf: {load_ms[False]:.3f} ms"
              f" (default), {load_ms[True]:.3f} ms (optimize=True, libzrt); "
              f"the optimized load serializes to the committed bins "
              f"{same_bins}")
        if not same_bins:
            raise AssertionError("optimized glTF load differs from the bins")

        def textured(scene_md, tex_dir, make):
            r = make((scene_md[0], scene_md[1]))
            tex, mat = textures_from_mesh_data(scene_md[1], tex_dir)
            if tex is None:
                raise AssertionError(f"textures in {tex_dir} did not load")
            r.set_environment(textures=tex, material_textures=mat)
            return r

        # Lit (K2g), shadowed (K2d, K2g) and flat (K1) frames from the
        # optimized glTF load, bit-equal to the bins' frames.
        lit_of, shadowed_of = {}, {}
        for name, scene_md, tex_dir in (
                ("bins", bins, SHOWCASE_DIR),
                ("glTF", (scene_o, md_o), SHOWCASE_SRC)):
            r = textured(scene_md, tex_dir, lit_renderer)
            lit_of[name] = (r, drive_lit(f"showcase from {name}", r, "k2g"))
            r = textured(scene_md, tex_dir, shadow_renderer)
            shadowed_of[name] = (r, drive_shadowed(
                f"showcase from {name}", r, ("k2d", "k2g")))
        _, flat_bins, *_ = drive("showcase from bins", bins, "auto", "k1")
        _, flat_gltf, *_ = drive("showcase from glTF", (scene_o, md_o),
                                 "auto", "k1")
        for label, a, b in (
                ("lit", lit_of["glTF"][1][:2], lit_of["bins"][1][:2]),
                ("shadowed", shadowed_of["glTF"][1][:3],
                 shadowed_of["bins"][1][:3]),
                ("flat", flat_gltf, flat_bins)):
            same = (np.array_equal(a[0], b[0])
                    and np.array_equal(a[1].view(np.int32),
                                       b[1].view(np.int32))
                    and (len(a) < 3 or torch.equal(a[2], b[2])))
            print(f"  showcase {label} frame, optimized glTF load vs bins: "
                  f"bit-equal {same}")
            if not same:
                raise AssertionError(f"showcase {label}: glTF frame differs "
                                     "from the bins frame")
        # Their busy time is traced in phase 6a: no trace may come before
        # the plain loops of the phases that follow.
        for label, of in (("lit", lit_of), ("shadowed", shadowed_of)):
            for name, (r, _) in of.items():
                ms = event_ms(r.render, 10)
                print(f"  showcase {label} 1080p from {name}: {ms:.4f} ms a "
                      f"frame (CUDA events, 10 frames)")

        # The default load (the app's) against its CPU frame, 5l's rule.
        r = textured((scene_d, md_d), SHOWCASE_SRC, lit_renderer)
        img_d, depth_d, _ = drive_lit("showcase from glTF, default load", r,
                                      "k2g")
        rc = textured((scene_d, md_d), SHOWCASE_SRC,
                      lambda smd: lit_renderer(smd, device="cpu"))
        img_c, depth_c = rc.render_and_read()
        lsb, over1 = lsb_diff(img_d, img_c)
        cov_same = np.array_equal(depth_d < 1.0, depth_c < 1.0)
        print(f"  showcase default glTF load card vs CPU frame: coverage "
              f"equal {cov_same}, max {lsb} LSB, {over1} px over 1 LSB")
        if not cov_same or lsb > LIT_MAX_LSB:
            raise AssertionError("default glTF load: card frame differs "
                                 "from the CPU frame")

        # The textures in other containers, through read_image.
        png_frame = lit_of["glTF"][1][:2]
        with open(SHOWCASE_GLTF) as f:
            doc = json.load(f)
        with tempfile.TemporaryDirectory() as tmp:
            shutil.copyfile(os.path.join(SHOWCASE_SRC, "buffer.bin"),
                            os.path.join(tmp, "buffer.bin"))
            images = {uri: read_png(os.path.join(SHOWCASE_SRC, uri))
                      for uri in (im["uri"] for im in doc["images"])}
            for ext in ("dds", "bmp", "tga", "ppm", "tif"):
                decode_ms = []
                for uri, rgba in images.items():
                    path = os.path.join(tmp, uri.replace(".png", f".{ext}"))
                    with open(path, "wb") as f:
                        f.write(container_bytes(rgba, ext))
                    t0 = time.perf_counter()
                    same = np.array_equal(read_image(path), rgba)
                    decode_ms.append((time.perf_counter() - t0) * 1000.0)
                    if not same:
                        raise AssertionError(f"{path}: decodes differently")
                doc_x = copy.deepcopy(doc)
                for im in doc_x["images"]:
                    im["uri"] = im["uri"].replace(".png", f".{ext}")
                gltf_x = os.path.join(tmp, f"showcase_{ext}.gltf")
                with open(gltf_x, "w") as f:
                    json.dump(doc_x, f)
                r = textured(load_gltf(gltf_x, optimize=True), tmp,
                             lit_renderer)
                img_x, depth_x, _ = drive_lit(f"showcase, {ext} textures", r,
                                              "k2g")
                same = (np.array_equal(img_x, png_frame[0])
                        and np.array_equal(depth_x.view(np.int32),
                                           png_frame[1].view(np.int32)))
                print(f"  {ext}: decode {decode_ms[0]:.3f} + "
                      f"{decode_ms[1]:.3f} ms (read_image, the two 32x32 "
                      f"textures), frame bit-equal to the PNG-textured one "
                      f"{same}")
                if not same:
                    raise AssertionError(f"{ext}-textured frame differs")

        # The quad, oct and pvar samplers on the card over a 1080p plane.
        arr = lit_of["glTF"][0].texture
        h, w = arr.base_shape
        n = arr.num_levels
        rng = np.random.default_rng(27)
        uv = torch.from_numpy(rng.random((HEIGHT, WIDTH, 2), np.float32)
                              * 3 - 1).to(dev)
        lod = torch.from_numpy(rng.random((HEIGHT, WIDTH), np.float32)
                               * (n - 1)).to(dev)
        layer = torch.from_numpy(rng.integers(
            0, arr.num_layers, (HEIGHT, WIDTH)).astype(np.int32)).to(dev)
        plain = sampling.sample_trilinear(arr.atlas_u32, h, w, n, uv, lod,
                                          layer)
        plain_ms = event_ms(lambda: sampling.sample_trilinear(
            arr.atlas_u32, h, w, n, uv, lod, layer), 10)
        print(f"  sample_trilinear over {WIDTH}x{HEIGHT} uv/lod/layer "
              f"({arr.num_layers} layers of {h}x{w}, {n} levels): "
              f"{plain_ms:.4f} ms")
        for kind in ("quad", "oct", "pvar"):
            t0 = time.perf_counter()
            atlas = getattr(arr, f"{kind}_atlas_u32")
            sync()
            build_ms = (time.perf_counter() - t0) * 1000.0
            fn = getattr(sampling, f"sample_trilinear_{kind}")
            got = fn(atlas, h, w, n, uv, lod, layer)
            same = (got.device == atlas.device == uv.device and torch.equal(
                got.view(torch.int32), plain.view(torch.int32)))
            ms = event_ms(lambda: fn(atlas, h, w, n, uv, lod, layer), 10)
            print(f"  sample_trilinear_{kind}: bit-equal to "
                  f"sample_trilinear {same}; {ms:.4f} ms (CUDA events), "
                  f"atlas {tuple(atlas.shape)} built on {atlas.device} in "
                  f"{build_ms:.3f} ms")
            if not same:
                raise AssertionError(f"sample_trilinear_{kind} differs")

        # The app off the .gltf: its textures bound, its frame the default
        # load's through the same config.
        with tempfile.TemporaryDirectory() as tmp:
            if app_main(["--scene", SHOWCASE_GLTF, "--pipeline", "lit",
                         "--frames", "1", "--out", tmp]) != 0:
                raise AssertionError("app --scene showcase.gltf failed")
            img_app = read_png(os.path.join(tmp, "frame_0000.png"))
        ra = Renderer(RenderConfig(width=WIDTH, height=HEIGHT,
                                   pipeline="lit"), device=DEVICE)
        ra.load_scene(scene_d, md_d)
        bind_scene_textures(ra, md_d, SHOWCASE_SRC)
        img_ref, _ = ra.render_and_read()
        spread = img_app[..., :3].reshape(-1, 3).std(axis=0)
        same = np.array_equal(img_app, img_ref)
        print(f"  app --scene showcase.gltf --pipeline lit: frame equal to "
              f"the default load's {same}, channel spread "
              f"{spread.round(2).tolist()}")
        if not same or not (spread > 5).all():
            raise AssertionError("app off the glTF: frame differs or "
                                 "textures not bound")
        return {label: {name: r for name, (r, _) in of.items()}
                for label, of in (("lit", lit_of),
                                  ("shadowed", shadowed_of))}

    asset_renderers = assets

    @phase("4s K3b/K9/K9g/K9d band kernels vs plain versions")
    def band_cases():
        cases = {}
        # (a) the test scene from 2 shards: K3b at rows 0 and 544.
        args, _ = scene_args(load_test_scene(), H2, tri_align=256)
        _, ti, tf, s = tiles.setups_in_turn(2, *args, PAD_W, H2)
        prep = raster.prepare_raster_inputs(ti, tf)
        for b in range(2):
            compare("k3b", f"(a) test scene band {b} of 2 (K3b)",
                    band_fn(k3b, b * 544), band_fn(
                        raster.raster_hier_band_plain, b * 544), prep,
                    PAD_W, 544)
        # (b) the 20K lattice from 2 shards: 32 288 gathered rows.
        args, _ = scene_args(make_stress_scene(20000), H2, tri_align=256)
        _, ti, tf, s = tiles.setups_in_turn(2, *args, PAD_W, H2)
        prep = raster.prepare_raster_inputs(ti, tf)
        print(f"  (b) lattice20k: {ti.shape[0]} gathered rows of 2 shards")
        for b in range(2):
            compare("k3b", f"(b) lattice20k band {b} of 2 (K3b)",
                    band_fn(k3b, b * 544),
                    band_fn(raster.raster_hier_band_plain, b * 544), prep,
                    PAD_W, 544,
                    plain_shape="lattice20k band 0 of 2" if b == 0 else None)
        cases["k3b"] = (prep, 0, 544, "lattice20k band 0 of 2",
                        band_pairs(ti, 0, 544))
        rows20, plain20_s = ti.shape[0], results["k3b"]["plain_ms"] / 1e3
        # (c) the 40K lattice from 4 shards at 1920x1024: K9 with both span
        # forms, K9g with random normals and per-triangle materials.
        args, lit_kw = scene_args(make_stress_scene(MID_TRIS), H4, lit=True)
        _, ti, tf, s = tiles.setups_in_turn(4, *args, PAD_W, H4, **lit_kw)
        print(f"  (c) lattice40k: {ti.shape[0]} gathered rows of 4 shards")
        for b in range(4):
            row0 = b * 256
            label = f"lattice40k band {b} of 4"
            for local in (True, False):
                band_kw = (dict(band_ty0=row0 // 32, band_tiles_y=8) if local
                           else {})
                prep = raster.prepare_binned_hbm_inputs(
                    ti, tf, PAD_W, H4, n_head=4 * s,
                    pair_budget=raster.band_pair_budget(4), **band_kw)
                n, longest, mean = span_stats(prep[0])
                print(f"  (c) {label}, {'band-local' if local else 'global'}"
                      f" spans: {n} records (longest span {longest})")
                compare_k9(f"(c) {label}", prep, row0, 256, local)
            prep = raster.prepare_binned_hbm_inputs(
                ti, tf, PAD_W, H4, n_head=4 * s,
                pair_budget=raster.band_pair_budget(4), band_ty0=row0 // 32,
                band_tiles_y=8)
            compare_gbuffer("k9g", f"(c) {label} (K9g)", band_fn(k9g, row0),
                            band_fn(raster.gbuffer_binned_band_plain, row0),
                            prep, PAD_W, 256)
        # (c2) the deferred test scene from 2 shards, its per-triangle
        # materials: K9g at the main path's shape, bands at rows 0 and 544.
        _, dargs = deferred_args("wide")
        _, ti, tf, s = tiles.setups_in_turn(
            2, *dargs[:5], PAD_W, H2, normal_matrices=dargs[5],
            material_table=dargs[6])
        for b in range(2):
            prep = raster.prepare_binned_hbm_inputs(
                ti, tf, PAD_W, H2, n_head=2 * s,
                pair_budget=raster.band_pair_budget(2), band_ty0=b * 17,
                band_tiles_y=17)
            label = f"deferred test scene band {b} of 2"
            compare_gbuffer("k9g", f"(c2) {label} (K9g)",
                            band_fn(k9g, b * 544),
                            band_fn(raster.gbuffer_binned_band_plain,
                                    b * 544), prep, PAD_W, 544,
                            plain_shape=label if b == 0 else None)
        # (d) binning="hierarchy" above 32768 rows: the 40K lattice from 2
        # shards through K3b (two groups of its walk), both bands at
        # HIER_ITEMS and HIER_SPLIT_ITEMS items a tile against the plain
        # K3b (unless (b)'s time, scaled by the rows, predicts more than
        # PLAIN_1M_MAX_S) and laid side by side against K5's frame.
        args40, _ = scene_args(make_stress_scene(MID_TRIS), H2)
        _, ti, tf, s = tiles.setups_in_turn(2, *args40, PAD_W, H2)
        prep = raster.prepare_raster_inputs(ti, tf)
        n_supers = prep[0].shape[0]
        print(f"  (d) lattice40k: {ti.shape[0]} gathered rows of 2 shards, "
              f"{n_supers} superblocks")
        if ti.shape[0] <= raster.MAX_RESIDENT_ROWS or n_supers <= 8:
            raise AssertionError("(d) does not pass the 32768-row bound")
        predicted = plain20_s * ti.shape[0] / rows20
        bands = {}
        for b in range(2):
            outs = [with_hier_items(k3b, n)(*prep, PAD_W, 544, b * 544)
                    for n in (raster.HIER_ITEMS, HIER_SPLIT_ITEMS)]
            sync()
            if not all(torch.equal(x, y) for x, y in zip(*outs)):
                raise AssertionError(f"(d) band {b}: the item counts differ")
            bands[b] = outs[0]
            label = f"(d) lattice40k band {b} of 2 (K3b, hierarchy)"
            if predicted > PLAIN_1M_MAX_S:
                print(f"  {label}: plain K3b skipped, {predicted:.1f} s "
                      f"predicted from (b) (limit {PLAIN_1M_MAX_S} s)")
                continue
            t0 = time.perf_counter()
            compare("k3b", label, band_fn(k3b, b * 544),
                    band_fn(raster.raster_hier_band_plain, b * 544), prep,
                    PAD_W, 544)
            print(f"    plain K3b {time.perf_counter() - t0:.1f} s "
                  f"(predicted {predicted:.1f} s)")
        c5, d5 = k5(*prep, PAD_W, H2)
        cb, db = (torch.cat([bands[0][i], bands[1][i]]) for i in range(2))
        if not (torch.equal(cb, c5) and torch.equal(
                db.view(torch.int32), d5.view(torch.int32))):
            raise AssertionError("(d) K3b's bands differ from K5's frame")
        print("  (d) both bands at both item counts equal K5's frame")
        # (e) a 2048-triangle clipped soup under a 16-record slab (256
        # after rounding), so that rows are demoted to the owners'
        # hierarchies: K9d with 2 and 4 sources.
        soup_md = make_triangle_soup(2048, seed=17, extent=2.0,
                                     triangle_size=0.5,
                                     behind_camera_fraction=0.1)
        v = soup_md[1].vertex_data.reshape(-1, 16)
        for t in range(40, 60):
            v[3 * t, 2] += 15.0
        for n, h in ((2, H2), (4, H4)):
            args, _ = scene_args(soup_md, h)
            locals_, ti, tf, s = tiles.setups_in_turn(n, *args, PAD_W, h)
            band_h = h // n
            demoted = False
            small, whole = (dist_received(locals_, h, n, s, slab)
                            for slab in (16, None))
            for b in range(n):
                sent = int(small[b][3][:, -1].sum().item())
                wanted = int(whole[b][3][:, -1].sum().item())
                demoted |= sent < wanted
                prep = raster.prepare_binned_dist_owner(ti, tf, *small[b])
                compare_k9d(f"(e) 2048-triangle clipped soup, slab 16, "
                            f"band {b} of {n} ({sent} of {wanted} records "
                            f"sent, the rest demoted)", prep, b * band_h,
                            band_h)
            if not demoted:
                raise AssertionError(f"(e) {n} bands: the 16-record slab "
                                     "demoted nothing")
        # (f) the 40K lattice from 2 shards at 1920x1088, the main path's
        # band shape: K9 with both span forms (plain K9 at 1M costs too
        # much; phase 5m holds the 1M bands against K4), and K9d under the
        # default slab.
        locals_, ti, tf, s = tiles.setups_in_turn(2, *args40, PAD_W, H2)
        for b in range(2):
            label = f"lattice40k band {b} of 2"
            for local in (True, False):
                band_kw = (dict(band_ty0=b * 17, band_tiles_y=17) if local
                           else {})
                prep = raster.prepare_binned_hbm_inputs(
                    ti, tf, PAD_W, H2, n_head=2 * s,
                    pair_budget=raster.band_pair_budget(2), **band_kw)
                compare_k9(f"(f) {label}", prep, b * 544, 544, local,
                           plain_shape=label if b == 0 and local else None)
        prep = raster.prepare_binned_dist_owner(
            ti, tf, *dist_received(locals_, H2, 2, s)[0])
        compare_k9d("(f) lattice40k band 0 of 2", prep, 0, 544,
                    plain_shape="lattice40k band 0 of 2")
        cases["k9d"] = (prep, 0, 544, "lattice40k band 0 of 2",
                        band_pairs(ti, 0, 544))
        return cases

    # -- 5m. the sharded frames, bands in turn -------------------------------
    @phase("5m sharded frames (bands in turn, one-rank NCCL group)")
    def bands_main():
        band_keys = ("k3b", "k9", "k9g", "k9d")

        def run(label, fn, key, ref_rgba, ref_depth, record=False):
            """Drive ``fn`` (the bands of one frame) with every launch
            count set to 0 just before and read just after; the bands laid
            side by side must equal the single-device frame.  ``record``:
            this frame is ``key``'s main path, whose count the kernels line
            reports."""
            sync()
            for kern in kernel_of.values():
                kern.launches = 0
            bands = fn()
            sync()
            launched = {k: kern.launches for k, kern in kernel_of.items()
                        if kern.launches}
            rgba = torch.cat([x[0] for x in bands])
            depth = torch.cat([x[1] for x in bands])
            same = (torch.equal(rgba, ref_rgba) and torch.equal(
                depth.view(torch.int32), ref_depth.view(torch.int32)))
            cov = (depth < 1.0).float().mean().item()
            shape = tuple(bands[0][0].shape)
            print(f"  {label}: {len(bands)} bands of {shape}, equal to the "
                  f"single-device frame {same}, coverage "
                  f"{cov:.4f}, launches {launched}", flush=True)
            if not same or cov <= MIN_COVERAGE or not launched.get(key):
                raise AssertionError(f"{label}: bands differ from the "
                                     f"single-device frame or skip {key}")
            if record:
                counts[key] = launched[key]
            return bands

        def single_flat(r, height, jitter=None):
            """The single-device frame at (WIDTH, height): (rgba, depth,
            packed)."""
            b = r._buffers()
            args = indexed_args(r, height, jitter)
            packed, depth = raster.render_frame(
                b["corner_cols"], b["tri_node"], args[3], WIDTH, height,
                height, PAD_W)
            return raster.unpack_rgba8(packed), depth, packed

        ref2 = single_flat(r_scene, H2)[:2]
        run("flat test scene, 2 bands, auto (K3b)",
            lambda: tiles.bands_in_turn(2, WIDTH, H2,
                                        *indexed_args(r_scene, H2)),
            "k3b", *ref2, record=True)
        for n, h in ((2, H2), (4, H4)):
            ref = single_flat(r_k4, h)[:2]
            run(f"lattice1M, {n} bands at {WIDTH}x{h}, auto (K9; "
                "single-device K4)",
                lambda n=n, h=h: tiles.bands_in_turn(
                    n, WIDTH, h, *indexed_args(r_k4, h)), "k9", *ref,
                record=n == 2)
        r40 = Renderer(RenderConfig(width=WIDTH, height=H2), device=DEVICE)
        r40.load_scene(*make_stress_scene(MID_TRIS))
        run("lattice40k, 2 bands, dist (K9d)",
            lambda: tiles.bands_in_turn(2, WIDTH, H2,
                                        *indexed_args(r40, H2), "dist"),
            "k9d", *single_flat(r40, H2)[:2], record=True)

        deferred_refs = {}
        for name in ("wide", "r2"):
            rd, dargs = deferred_args(name)
            img, depth = rd.render()
            run(f"deferred test scene, {name} lights, 2 bands (K9g + K7)",
                lambda dargs=dargs: tiles.deferred_bands_in_turn(
                    2, WIDTH, H2, *dargs), "k9g", img, depth,
                record=name == "wide")
            deferred_refs[name] = (dargs, img, depth)

        # Config 4 with 2 bands: the 1M lattice over 8 jittered frames,
        # the halo-row resolve per band, against K4 + taa_resolve_packed.
        jitters = taa.jitter_sequence(CONFIG4_FRAMES)
        hist_p = None
        hists = [None, None]
        for k in range(CONFIG4_FRAMES):
            rgba1, depth1, packed = single_flat(r_k4, H2, jitters[k])
            if hist_p is None:
                hist_p = taa.taa_init_history_packed(packed)
            hist_p, res_p = taa.taa_resolve_packed(hist_p, packed)
            bands = run(f"config 4 frame {k}: lattice1M, 2 bands (K9)",
                        lambda k=k: tiles.bands_in_turn(
                            2, WIDTH, H2, *indexed_args(r_k4, H2, jitters[k])),
                        "k9", rgba1, depth1)
            out = tiles.taa_bands_in_turn([x[0] for x in bands], hists)
            hists = [x[0] for x in out]
            same = (torch.equal(torch.cat([x[1] for x in out]),
                                raster.unpack_rgba8(res_p))
                    and torch.equal(torch.cat(hists),
                                    hist_p.permute(1, 2, 0)))
            if not same:
                raise AssertionError(f"config 4 frame {k}: the banded "
                                     "resolve differs from K4 + "
                                     "taa_resolve_packed")
        print(f"  config 4, 2 bands: {CONFIG4_FRAMES} resolved frames and "
              "histories equal to K4 + taa_resolve_packed")

        # The collective code on CUDA tensors: a real one-rank NCCL group.
        import socket

        import torch.distributed as torch_dist

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        multihost.initialize(f"127.0.0.1:{port}", 1, 0, device=DEVICE)
        try:
            group = multihost.global_tile_mesh()
            flat_args = indexed_args(r_scene, H2)
            for label, (fn, shard) in (
                    ("make_sharded_frame", tiles.make_sharded_frame(
                        group, WIDTH, H2, device=DEVICE)),
                    ("make_sharded_frame_2d", tiles.make_sharded_frame_2d(
                        group, 1, WIDTH, H2, device=DEVICE)),
                    ("make_multihost_frame dist",
                     multihost.make_multihost_frame(
                         group, WIDTH, H2, "dist", device=DEVICE))):
                rgba, depth = fn(*shard(*flat_args))
                same = (torch.equal(rgba, ref2[0]) and torch.equal(
                    depth.view(torch.int32), ref2[1].view(torch.int32)))
                gathered = multihost.gather_frame(rgba, group)
                print(f"  NCCL, 1 rank, {label}: equal to the single-device"
                      f" frame {same}, gather_frame equal "
                      f"{np.array_equal(gathered, rgba.cpu().numpy())}")
                if not same or not np.array_equal(gathered,
                                                  rgba.cpu().numpy()):
                    raise AssertionError(f"NCCL {label} differs")
            fn, shard = tiles.make_sharded_deferred_frame(group, WIDTH, H2,
                                                          device=DEVICE)
            dargs, img, depth_ref = deferred_refs["r2"]
            rgba, depth = fn(*shard(*dargs))
            same = (torch.equal(rgba, img) and torch.equal(
                depth.view(torch.int32), depth_ref.view(torch.int32)))
            print(f"  NCCL, 1 rank, make_sharded_deferred_frame (r2): equal "
                  f"to the single-device frame {same}")
            taa_fn, shard = tiles.make_sharded_taa_frame(group, WIDTH, H2,
                                                         device=DEVICE)
            resolved, _, hist = taa_fn(*shard(*flat_args))
            want_h, want = taa.taa_resolve(taa.taa_init_history(ref2[0]),
                                           ref2[0])
            same_taa = (torch.equal(resolved, want)
                        and torch.equal(hist, want_h))
            print(f"  NCCL, 1 rank, make_sharded_taa_frame: equal to "
                  f"taa_resolve of the single-device frame {same_taa}")
            if not same or not same_taa:
                raise AssertionError("NCCL deferred or TAA frame differs")
        finally:
            torch_dist.destroy_process_group()
        print(f"  band kernel launches in one main-path frame: "
              f"{ {k: counts[k] for k in band_keys} }")
        return deferred_refs, r40

    deferred_band_refs, r_lattice40 = bands_main or (None,) * 2

    # -- 4x. K10g8/K10g8g/K10g8d/K10vec/K10vecg vs plain ---------------------
    def vec_prepare(ti, tf, w, h):
        return vec.prepare_vec_inputs(ti, tf)

    x_cases = {  # key: (kernel, plain version, prepare, comparison)
        "k10g8": (kx8, group8.raster_group8_plain,
                  group8.prepare_group8_inputs, compare),
        "k10g8g": (kx8g, group8.gbuffer_group8_plain,
                   group8.prepare_group8_inputs, compare_gbuffer),
        "k10g8d": (kx8d, group8.depth_group8_plain,
                   group8.prepare_group8_inputs, compare_depth),
        "k10vec": (kxv, vec.raster_vec_plain, vec_prepare, compare),
        "k10vecg": (kxvg, vec.gbuffer_vec_plain, vec_prepare,
                    compare_gbuffer),
    }

    def leftover_rows(hier):
        """Live rows a group8 prepare leaves to the hierarchy (phase 2)."""
        return int(((hier[:, tg.I_VALID] > 0)
                    & (hier[:, tg.I_JMIN] <= hier[:, tg.I_JMAX])
                    & (hier[:, tg.I_IMIN] <= hier[:, tg.I_IMAX])).sum().item())

    def x_rows(key, scene_md, w, h):
        """Setup rows of ``scene_md`` at (w, h) for kernel ``key``: with
        the lit columns (random normals, one random material per
        triangle) for the G-buffer kernels."""
        if key.endswith("g"):
            return lit_rows(*scene_md, w, h)
        return setup_rows(*scene_md, w, h)

    def x_check(key, label, rows, w, h, plain_shape=None, **kw):
        """Kernel ``key`` against its plain version on ``rows``: every
        plane bitwise as int32; prints the rows each phase holds."""
        kern, plain, prepare, cmp = x_cases[key]
        prep = prepare(*rows, w, h, **kw)
        if key.startswith("k10g8"):
            print(f"  {label} ({key}, {w}x{h}, {kw or 'defaults'}): "
                  f"{int(prep.offs[-1].item())} listed pairs (L "
                  f"{prep.rows.shape[0]}), {leftover_rows(prep.hier)} "
                  f"leftover rows, tile_any on "
                  f"{int(prep.tile_any.sum().item())} of "
                  f"{prep.tile_any.numel()} tiles")
        else:
            sg = prep[2][::vec.SUBGROUP, 24:28]
            live = int(((sg[:, 0] <= sg[:, 1]) & (sg[:, 2] <= sg[:, 3]))
                       .sum().item())
            print(f"  {label} ({key}, {w}x{h}): {prep[2].shape[0]} records, "
                  f"{live} of {sg.shape[0]} subgroups live")
        out = cmp(key, f"{label} ({key})", kern, plain, prep, w, h,
                  plain_shape)
        if key in x_resolve_names:
            one = at_x_items(key, 1, lambda: kern(*prep, w, h))
            same = same_planes(one, out)
            print(f"    ({key} at 1 work item a tile: bit-exact against "
                  f"{x_items(key)} items {same})")
            if not same:
                raise AssertionError(f"{label}: {key} at 1 item differs")
        return prep, out

    def blow_up_soup():
        """The reference experiment tests' soup (tests/test_raster_group8.py
        ``_setup_soup``): 150 triangles, 20-29 scaled ten times (past
        pair_cap), a corner of 30-39 through the near plane (fan rows)."""
        scene, md = make_triangle_soup(150, seed=3, extent=2.0,
                                       behind_camera_fraction=0.1)
        v = md.vertex_data.reshape(-1, 16)
        for t in range(20, 30):
            tri = v[3 * t:3 * t + 3, 0:3]
            c = tri.mean(axis=0)
            v[3 * t:3 * t + 3, 0:3] = c + (tri - c) * 10.0
        for t in range(30, 40):
            v[3 * t, 2] += 15.0
        return scene, md

    def same_planes(a, b):
        a, b = (list(x) if isinstance(x, (list, tuple)) else [x]
                for x in (a, b))
        return all(torch.equal(x.contiguous().view(torch.int32),
                               y.contiguous().view(torch.int32))
                   for x, y in zip(a, b))

    @phase("4x K10g8/K10vec experiment kernels vs plain versions")
    def experiment_cases():
        S = SHADOW_SIZE
        # (a) The path's shapes: 1920x1088, the 40K lattice; the G-buffer
        # kernels also on the test scene; K10g8d on the 20K lattice's
        # light view into the 1024x1024 map.
        lattice_mid = make_stress_scene(MID_TRIS)
        rows40 = setup_rows(*lattice_mid, WIDTH, HEIGHT, tri_align=256)
        for key in ("k10g8", "k10vec"):
            t0 = time.perf_counter()
            x_check(key, "lattice40k", rows40, PAD_W, PAD_H,
                    plain_shape="lattice40k")
            print(f"  (plain {key} included: "
                  f"{time.perf_counter() - t0:.1f} s)")
        scene_rows = lit_rows(*load_test_scene(), WIDTH, HEIGHT, 256)
        lit40 = lit_rows(*lattice_mid, WIDTH, HEIGHT, 256)
        for key in ("k10g8g", "k10vecg"):
            x_check(key, "test scene", scene_rows, PAD_W, PAD_H)
            t0 = time.perf_counter()
            x_check(key, "lattice40k", lit40, PAD_W, PAD_H,
                    plain_shape="lattice40k")
            print(f"  (plain {key} included: "
                  f"{time.perf_counter() - t0:.1f} s)")
        map20 = light_rows(shadow_renderer(lattice))
        x_check("k10g8d", "lattice20k, light view", map20, S, S,
                plain_shape="lattice20k map")

        # (b) The soups, every kernel.
        clipped = clipped_soup()
        for key in x_cases:
            x_check(key, "clipped soup", x_rows(key, clipped, WIDTH, HEIGHT),
                    PAD_W, PAD_H)
        w, h = 1024, 512
        dup, one = tie_soup(True), tie_soup(False)
        for key, (kern, _, prepare, _) in x_cases.items():
            _, out_dup = x_check(key, "duplicated triangles",
                                 x_rows(key, dup, w, h), w, h)
            out_one = kern(*prepare(*x_rows(key, one, w, h), w, h), w, h)
            if not same_planes(out_dup, out_one):
                raise AssertionError(f"{key}: a duplicate won a depth tie")
        print("  every exact depth tie went to the first-submitted row "
              "(K10g8, K10g8g, K10g8d, K10vec, K10vecg)")
        # The blow-up soup at the reference test's 256x64: oversized rows
        # past pair_cap and fan rows, so both of group8's phases draw (at
        # 1080p its triangles span too many tiles to be listed); then a
        # 32-row list budget.
        blow = blow_up_soup()
        w, h = 256, 64
        for key in x_cases:
            rows = x_rows(key, blow, w, h)
            prep, full = x_check(key, "blow-up soup", rows, w, h)
            if not key.startswith("k10g8"):
                continue
            kern = x_cases[key][0]
            zero = torch.zeros_like(prep.tile_any)
            only1 = kern(*prep._replace(tile_any=zero), w, h)
            only2 = kern(*prep._replace(offs=torch.zeros_like(prep.offs)),
                         w, h)
            z1, z2, zf = ((x if key == "k10g8d" else x[1])
                          for x in (only1, only2, full))
            drawn1 = int((z1 < 1.0).sum().item())
            drawn2 = int((z2 < 1.0).sum().item())
            print(f"  blow-up soup ({key}): phase 1 alone draws {drawn1} "
                  f"pixels, phase 2 alone {drawn2}, both "
                  f"{int((zf < 1.0).sum().item())}")
            if drawn1 == 0 or drawn2 == 0 or same_planes(only1, full) \
                    or same_planes(only2, full):
                raise AssertionError(f"{key}: a phase of the blow-up soup "
                                     "draws nothing")
            tiny = dict(list_budget=32, chunk=16)
            prep_t, out_t = x_check(key, "blow-up soup, list_budget=32", rows,
                                    w, h, **tiny)
            if int(prep_t.offs[-1].item()) >= int(prep.offs[-1].item()):
                raise AssertionError("the 32-row list budget demoted nothing")
            if not same_planes(out_t, full):
                raise AssertionError(f"{key}: the list budget changed the "
                                     "frame")
        print("  the 32-row list budget leaves every group8 frame unchanged")
        # The edge-clamped rows: valid rows whose bbox clamps to empty at
        # the map's edges and past them (both tile ranges reversed
        # included), which the group8 prepare treats as dead.
        for key in x_cases:
            rows = x_rows(key, edge_soup(), S, S)
            head = rows[0][:tg.head_count(rows[0].shape[0])]
            valid = head[:, tg.I_VALID] > 0
            ntx = (head[:, tg.I_JMAX] // group8.GT_W
                   - head[:, tg.I_JMIN] // group8.GT_W + 1)
            nty = (head[:, tg.I_IMAX] // group8.GT_H
                   - head[:, tg.I_IMIN] // group8.GT_H + 1)
            empty = valid & ((head[:, tg.I_JMIN] > head[:, tg.I_JMAX])
                             | (head[:, tg.I_IMIN] > head[:, tg.I_IMAX]))
            both = int((valid & (ntx < 0) & (nty < 0)).sum().item())
            print(f"  edge soup ({key}): {int(empty.sum().item())} valid "
                  f"rows clamped to an empty bbox, {both} with both 8x128 "
                  "tile ranges reversed")
            if both == 0:
                raise AssertionError("edge soup: no row past both edges")
            _, out = x_check(key, "edge soup", rows, S, S)
            if key in ("k10g8", "k10vec"):
                ref = k5(*raster.prepare_raster_inputs(*rows), S, S)
                if not same_planes(out, ref):
                    raise AssertionError(f"edge soup: {key} and K5 differ")
        print("  edge soup: K10g8 and K10vec maps equal K5's bitwise")
        # No live row at all: every plane the background.
        t = tg.capped_rows(64)
        ti = torch.zeros((t + (-t) % 64, tg.NI32), dtype=torch.int32,
                         device=dev)
        ti[:, tg.I_JMIN] = 1
        ti[:, tg.I_BIAS0:tg.I_BIAS2 + 1] = 2**31 - 1
        tf = torch.zeros((ti.shape[0], tg.NF32), device=dev)
        for key, (kern, plain, prepare, _) in x_cases.items():
            w, h = (S, S) if key == "k10g8d" else (PAD_W, PAD_H)
            prep = prepare(ti, tf, w, h)
            out, ref = kern(*prep, w, h), plain(*prep, w, h)
            planes = [out] if key == "k10g8d" else out
            background = bool((planes[0 if key == "k10g8d" else 1] == 1.0)
                              .all().item())
            if key != "k10g8d":
                background &= bool((planes[0] == -(1 << 24)).all().item())
                background &= not any(bool(p.any().item())
                                      for p in planes[2:])
            print(f"  empty scene ({key}): bit-exact={same_planes(out, ref)}"
                  f", background only {background}")
            if not (same_planes(out, ref) and background):
                raise AssertionError(f"empty scene: {key} drew something")
        return lit40, map20, scene_rows

    x_lit40, x_map20, x_scene_rows = experiment_cases or (None,) * 3

    # The 1M lattice's rows at 1080p: phase 5b's, or where ``--phases``
    # skipped 5b, the port's geometry on the card.
    rows_1m = rows_lattice or setup_rows(*make_stress_scene(LARGE_TRIS),
                                         WIDTH, HEIGHT)
    # Its lit rows: phase 5l's, or where ``--phases`` skipped 5l, built on
    # the card once, when 5x or 6x first asks.
    lit_1m_built = []

    def lit_rows_1m():
        if rows_lit_big is not None:
            return rows_lit_big
        if not lit_1m_built:
            lit_1m_built.append(lit_rows(*make_stress_scene(LARGE_TRIS),
                                         WIDTH, HEIGHT))
        return lit_1m_built[0]

    def gbuffer_clear(planes):
        """Every pixel of the G-buffer ``planes`` holds the clear values:
        alpha alone, depth 1.0, every further plane 0.0."""
        return (bool((planes[0] == -(1 << 24)).all().item())
                and bool((planes[1] == 1.0).all().item())
                and not any(bool(p.view(torch.int32).any().item())
                            for p in planes[2:]))

    # -- 5x. the experiment frames at 1M --------------------------------------
    @phase("5x experiment frames at 1M")
    def experiment_frames():
        """K10g8 and K10vec on the 1M lattice at 1920x1088 through their
        entry points, each with every launch count set to 0 just before
        and read just after; their frames held against K5's and K4's (K4
        is held against its plain version at 1M in phase 5b).  Then each
        kernel against its own plain version on one 1M prepare, all 1088
        rows bitwise, so that the padding rows' rule is the plain
        version's too.  Then the G-buffer entry points once each on the
        1M lattice's lit rows, the 13 planes of rows 0-1079 against K5g's
        and rows 1080-1087 clear, and the depth entry point on the 20K
        lattice's map against K3d."""
        ti, tf = rows_1m
        c5, d5 = k5(*raster.prepare_raster_inputs(ti, tf), PAD_W, PAD_H)
        c4, d4 = k4(*raster.prepare_binned_hbm_inputs(ti, tf, PAD_W, PAD_H),
                    PAD_W, PAD_H)
        vis, pad = slice(0, HEIGHT), slice(HEIGHT, PAD_H)

        def drawn(d):
            return int((d[pad] < 1.0).sum().item())

        print(f"  lattice1M padding rows {HEIGHT}-{PAD_H - 1}: K5 draws "
              f"{drawn(d5)} pixels, K4 {drawn(d4)}")

        def entry(key, fn, *args):
            sync()
            for kern in kernel_of.values():
                kern.launches = 0
            out = fn(*args)
            sync()
            launched = {k: kern.launches for k, kern in kernel_of.items()
                        if kern.launches}
            if launched != {key: 1}:
                raise AssertionError(f"{key}: launches {launched}, one "
                                     f"{key} launch expected")
            counts[key] = 1
            return out

        for key, fn in (("k10g8", group8.rasterize_setup_group8),
                        ("k10vec", vec.rasterize_setup_vec)):
            c, d = entry(key, fn, ti, tf, PAD_W, PAD_H)
            same5 = same_planes((c[vis], d[vis]), (c5[vis], d5[vis]))
            same4 = same_planes((c[vis], d[vis]), (c4[vis], d4[vis]))
            pad5 = same_planes((c[pad], d[pad]), (c5[pad], d5[pad]))
            clear = (bool((d[pad] == 1.0).all().item())
                     and bool((c[pad] == -(1 << 24)).all().item()))
            cov = (d[vis] < 1.0).float().mean().item()
            print(f"  lattice1M {PAD_W}x{PAD_H} ({key}, one launch): "
                  f"visible rows equal K5's {same5} and K4's {same4} "
                  f"(RGBA and depth bits), coverage {cov:.4f}; padding rows "
                  f"equal K5's {pad5}, clear {clear} ({drawn(d)} drawn)")
            if not (same5 and same4) or cov <= MIN_COVERAGE:
                raise AssertionError(f"lattice1M: {key} differs from K5/K4 "
                                     "in the visible rows")
            if not clear:
                raise AssertionError(f"lattice1M: {key} drew padding rows")
        for key in ("k10g8", "k10vec"):
            kern, plain, prepare, _ = x_cases[key]
            prep = prepare(ti, tf, PAD_W, PAD_H)
            out = kern(*prep, PAD_W, PAD_H)
            sync()
            t0 = time.perf_counter()
            ref = plain(*prep, PAD_W, PAD_H)
            sync()
            secs = time.perf_counter() - t0
            same = same_planes(out, ref)
            results[key]["plain_s_1m"] = secs
            print(f"  lattice1M {PAD_W}x{PAD_H} ({key}): kernel and plain "
                  f"version bit-exact in all {PAD_H} rows {same} (RGBA and "
                  f"depth bits; plain version {secs:.1f} s)", flush=True)
            if not same:
                raise AssertionError(f"lattice1M: {key} and its plain "
                                     "version differ")
        lit = lit_rows_1m()
        g5 = k5g(*raster.prepare_raster_inputs(*lit), PAD_W, PAD_H)
        for key, fn in (("k10g8g", group8.rasterize_gbuffer_group8),
                        ("k10vecg", vec.rasterize_gbuffer_vec)):
            out = entry(key, fn, *lit, PAD_W, PAD_H)
            same = same_planes([p[vis] for p in out], [p[vis] for p in g5])
            clear = gbuffer_clear([p[pad] for p in out])
            cov = (out[1][vis] < 1.0).float().mean().item()
            print(f"  lit lattice1M {PAD_W}x{PAD_H} G-buffer ({key}, one "
                  f"launch): the 13 planes of rows 0-{HEIGHT - 1} equal "
                  f"K5g's {same}, coverage {cov:.4f}; rows {HEIGHT}-"
                  f"{PAD_H - 1} clear in every plane {clear} (K5g draws "
                  f"{drawn(g5[1])} pixels there)")
            if not same or cov <= MIN_COVERAGE:
                raise AssertionError(f"lit lattice1M: {key} differs from "
                                     "K5g in the visible rows")
            if not clear:
                raise AssertionError(f"lit lattice1M: {key} drew padding "
                                     "rows")
        del g5, out
        S = SHADOW_SIZE
        dmap = entry("k10g8d", group8.rasterize_depth_group8, *x_map20, S, S)
        same = torch.equal(dmap, k3d(*raster.prepare_raster_inputs(*x_map20),
                                     S, S))
        print(f"  lattice20k map ({S}x{S}, k10g8d, one launch): equal to "
              f"K3d's by value {same}")
        if not same:
            raise AssertionError("lattice20k map: K10g8d differs from K3d")
        print(f"  launches in one main-path frame: "
              f"{ {k: counts[k] for k in x_cases} }")

    def entry_split(key, events):
        """An entry point's device ops split around its kernel's call: (ops
        and device ms before the call's first op, the call's, after its last
        op), in time order: the prepare, the kernel, the resolve."""
        ev = sorted(events, key=lambda e: e[1])
        ops = call_ops(key)
        first = next(i for i, e in enumerate(ev) if ops[0] in e[0])
        last = max(i for i, e in enumerate(ev) if ops[-1] in e[0])
        parts = (ev[:first], ev[first:last + 1], ev[last + 1:])
        return [(len(p), sum(e[2] for e in p) / 1000.0) for p in parts]

    def x_work(key, prep, w, h):
        """The work K10vec's, K10vecg's, K10g8's, K10g8g's or K10g8d's
        keyed body needs on ``prep``: (admitted (tile, row) pairs and list
        entries, their window pixel evaluations, bytes needed).  A pair's
        window is
        its row's vertices' pixel bbox in the tile within the kernel's
        extent (``vec.window_rects``: its subgroup's hit chunks;
        ``group8.window_rects``: an entry's list tile, a leftover row's
        gated list tiles): inside the geometry's rows it holds every pixel
        the row covers, in the padding rows the kernel's own extent.  The
        bytes: the tables (the vec kernels the superblocks and blocks and
        each hit block's four subgroup bboxes; the group8 kernels the
        spans, the gate, the entries' row ids, the superblocks and
        blocks), each admitted row's 20 setup ints and 3 z floats once,
        each distinct winning row's WINNER_BYTES the store reads
        (WINNER_GBUF_BYTES for the G-buffer forms, none for K10g8d, whose
        key holds z; the winners from the pairs' keys scatter-minned over
        their windows, the kernels' rule in torch) and the 2, 13 or 1
        planes."""
        if key.startswith("k10vec"):
            supers, blocks, rec = prep
            hits = raster.hier_block_hits(supers, blocks, w, h)
            rows, ty, tx = vec.admitted_rows(hits, rec, w)
            rect = vec.window_rects(rec, rows, ty, tx)
            tables = (sum(t.numel() * t.element_size()
                          for t in (supers, blocks))
                      + int(hits.any(0).sum().item())
                      * (tg.RASTER_BLOCK // vec.SUBGROUP) * 16)
            kh = h
            keys = torch.full((kh * w,), vec.KEY_CLEAR, dtype=torch.int64,
                              device=dev)
            vec.window_keys(keys, rec, rows, rect, ty, tx, w)
            won = keys != vec.KEY_CLEAR
        else:
            rows_l, ly, tx_l, _, _ = group8.list_pairs(prep, w, h)
            rect_l = group8.window_rects(prep, rows_l, ly // group8.LISTS,
                                         tx_l, w, h, list_y=ly)
            _, rows_o, ty_o, tx_o = group8.leftover_pairs(prep, w, h)
            rect_o = group8.window_rects(prep, rows_o, ty_o, tx_o, w, h)
            rows, rect = (torch.cat([rows_l, rows_o]),
                          torch.cat([rect_l, rect_o]))
            ty = torch.cat([ly // group8.LISTS, ty_o])
            tx = torch.cat([tx_l, tx_o])
            nsup = prep.blocks.shape[0] // tg.SUPER_BLOCK
            tables = (sum(t.numel() * t.element_size()
                          for t in (prep.offs, prep.tile_any,
                                    prep.supers[:nsup], prep.blocks))
                      + rows_l.numel() * 4)
            kh = group8.key_height(h)
            keys = torch.full((kh * w,), hbm2.KEY_CLEAR, dtype=torch.int64,
                              device=dev)
            group8.window_keys(keys, prep, rows, rect, ty, tx, w)
            won = keys != hbm2.KEY_CLEAR
        gbuffer, depth = key.endswith("g"), key.endswith("d")
        winners = int(torch.unique(keys[won] & 0xFFFFFFFF).numel())
        evals = int(((rect[:, 1] - rect[:, 0] + 1).clamp(min=0)
                     * (rect[:, 3] - rect[:, 2] + 1).clamp(min=0))
                    .sum().item())
        planes = raster.GBUFFER_PLANES if gbuffer else 1 if depth else 2
        nbytes = (tables + torch.unique(rows).numel() * (tg.NI32 * 4 + 12)
                  + winners * (WINNER_GBUF_BYTES if gbuffer else 0 if depth
                               else WINNER_BYTES)
                  + planes * 4 * w * kh)
        print(f"  {key} work at {w}x{h}: {rows.numel()} pairs of "
              f"{torch.unique(rows).numel()} rows, {winners} winning rows; "
              f"{evals} window pixel evaluations, {nbytes} bytes")
        return rows.numel(), evals, nbytes

    # -- 6x. the experiment kernels' times ------------------------------------
    # -- 5e. the engine API -----------------------------------------------
    def flat_renderer(scene_md, **kw):
        """A flat 1080p Renderer on the card with ``scene_md`` loaded;
        ``kw``: further RenderConfig fields."""
        r = Renderer(RenderConfig(width=WIDTH, height=HEIGHT, **kw),
                     device=DEVICE)
        r.load_scene(*scene_md)
        return r

    def shift_x(positions, attrs):
        """The exact vertex shader: x + 0.5 (a power of two) in object
        space, as the host moves the vertices in ``host_moved``."""
        return (torch.cat([positions[:, :1] + 0.5, positions[:, 1:]], 1),
                attrs)

    def host_moved(scene_md):
        """The scene with every vertex's x moved by 0.5 on the host."""
        scene, md = scene_md
        md = copy.deepcopy(md)
        md.vertex_data.reshape(-1, 16)[:, 0] += np.float32(0.5)
        return scene, md

    def launched_in(fn):
        """``fn``'s result and the launches of each kernel in it, every
        count set to 0 just before and read just after."""
        for kern in kernel_of.values():
            kern.launches = 0
        out = fn()
        return out, {k: kern.launches for k, kern in kernel_of.items()
                     if kern.launches}

    def frame_time(fn, reps=5):
        """(ms a call of ``fn`` between CUDA events over ``reps`` calls,
        device busy ms of one traced call, its device ops, idle share)."""
        fn()
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        events, window = device_trace(fn)
        busy = busy_us(events)
        return (start.elapsed_time(end) / reps, busy / 1000.0, len(events),
                1.0 - busy / window)

    def print_time(label, t):
        ms, busy, ops, idle = t
        print(f"  {label}: {ms:.4f} ms a frame (CUDA events), device busy "
              f"{busy:.4f} ms in {ops} device ops, idle share {idle:.4f} "
              f"({card})", flush=True)

    def same_frame(a, b):
        """Two (rgba, depth) host frames equal, depth as int32 bits."""
        return (np.array_equal(a[0], b[0])
                and np.array_equal(a[1].view(np.int32), b[1].view(np.int32)))

    def expect_launches(label, launched, want):
        """``want``: each kernel key launched exactly once, nothing else."""
        print(f"  {label}: launches {launched}", flush=True)
        if launched != {k: 1 for k in want}:
            raise AssertionError(f"{label}: launches {launched}, expected "
                                 f"{sorted(want)} once each")

    MESH_QUADS = 708  # the mesh pipeline's grid: 708 x 708 quads

    def grid_geometry():
        """The mesh pipeline's generator: a grid of MESH_QUADS^2 quads
        (1 002 528 triangles) in the z = 0 plane over [-1, 1]^2, coloured by
        position, every tensor made on the card."""
        n = MESH_QUADS
        xs = torch.linspace(-1.0, 1.0, n + 1, device=dev)
        py, px = torch.meshgrid(xs, xs, indexing="ij")
        v = (n + 1) * (n + 1)
        px, py = px.reshape(-1), py.reshape(-1)
        zeros = torch.zeros(v, device=dev)
        positions = torch.stack([px, py, zeros, zeros + 1.0], 1)
        attrs = torch.zeros((v, 12), device=dev)
        attrs[:, 0] = (px + 1.0) * 0.5
        attrs[:, 1] = (py + 1.0) * 0.5
        attrs[:, 2] = 0.3
        attrs[:, 3] = 1.0
        cell = torch.arange(n * n, dtype=torch.int32, device=dev)
        r0 = (cell // n) * (n + 1) + cell % n
        tri = torch.stack([r0, r0 + 1, r0 + n + 2, r0, r0 + n + 2,
                           r0 + n + 1], 1).reshape(-1, 3)
        return (positions, attrs, tri,
                torch.zeros(v, dtype=torch.int32, device=dev))

    def grid_scene(camera):
        """The grid's buffers as a one-node scene on the host, seen from
        ``camera``: the same geometry through load_scene."""
        p, a, t, _ = (x.cpu().numpy() for x in grid_geometry())
        verts = np.zeros((len(p), 16), np.float32)
        verts[:, 0:3] = p[:, :3]
        verts[:, 5:9] = a[:, 0:4]
        verts[:, 3:5] = a[:, 4:6]
        verts[:, 9:12] = a[:, 6:9]
        verts[:, 12:15] = a[:, 9:12]
        md = MeshData()
        md.append_mesh(verts, t.reshape(-1).astype(np.uint32))
        scene = Scene()
        scene.nodes.append(Node(mesh_indices=[0], transform_index=0,
                                name="grid"))
        scene.transforms.append(np.eye(4, dtype=np.float32))
        scene.cameras.append(camera)
        return scene, md

    # -- 4f and 5f: the frame at its rendered extent ------------------------
    def target_rows(r):
        """The setup rows of a flat renderer's current frame at its
        rendered extent (supersample times the frame), on its device."""
        b = r._buffers()
        mats = torch.from_numpy(r.camera_matrices()).to(r.device)
        w, h = r._flat_target()[:2]
        return tg.geometry_pipeline_cols(b["corner_cols"], b["tri_node"],
                                         mats, w, h), mats

    def keep_share(r):
        """(the device keep mask of r's current frame, the host's on the
        same inputs)."""
        mats = torch.from_numpy(r.camera_matrices())
        cam = torch.from_numpy(r.cam_local_constants())
        keep = tg.meshlet_keep_mask(*r._meshlet_table, mats.to(dev),
                                    cam.to(dev))
        host = tg.meshlet_keep_mask(*(t.cpu() for t in r._meshlet_table),
                                    mats, cam)
        return keep, host

    def budgets(label, ti, tf, w, h):
        """Print the record prepare's budgets at this frame: its caps, the
        listed pairs against the pair budget, the leftover rows and the
        keyed blocks.  A row past a budget falls to the leftover hierarchy
        and is drawn; only the capped clipper drops rows (checked by the
        caller)."""
        n_head = tg.head_count(ti.shape[0])
        cap = raster.hbm_cap_for(n_head)
        prep = raster.prepare_binned_hbm_inputs(ti, tf, w, h)
        pairs = int(prep[0][-1].item())
        budget = min(raster.HBM_PAIR_BUDGET, n_head * cap)
        leftover = int((prep[5][:, tg.I_VALID] > 0).sum().item())
        items = raster.keyed_items(w, h, prep[1].shape[0],
                                   raster.ITEM_RECORDS,
                                   min_items=raster.KEYED_MIN_ITEMS)
        print(f"    {label} {w}x{h}: {n_head} head rows, hbm_cap_for "
              f"{cap}, bin_cap_for {raster.bin_cap_for(n_head)}, listed "
              f"pairs {pairs} of the {budget} budget, leftover rows "
              f"{leftover}, keyed blocks {items}")

    # -- 4f. K1 and K4 at 3840x2176 against their plain versions ----------
    @phase("4f K1/K4 at the SSAA 2 extent vs plain versions")
    def ssaa_extent_plain():
        """K1 and K4 bitwise against their plain versions at 3840x2176, on
        the rows phase 5f's supersample=2 frames give them: the test scene
        (K1), and the culled rows of a field well under 1M (K4; the plain
        version's time grows with the longest tile list).  Run before 5e:
        a plain version's loops after the process's first trace cost a
        later trace its kernel records."""
        rs = flat_renderer(load_test_scene(), supersample=2)
        (ti, tf), _ = target_rows(rs)
        _, _, ph, pw = rs._flat_target()
        compare("k1", "test scene, supersample=2", k1,
                raster.raster_small_plain,
                raster.prepare_binned_small(ti, tf, pw, ph), pw, ph)
        r_s = flat_renderer(make_sphere_field(SMALL_FIELD_TRIS),
                            supersample=2, meshlet_cull=True)
        (ti, tf), mats = target_rows(r_s)
        _, _, ph, pw = r_s._flat_target()
        cam = torch.from_numpy(r_s.cam_local_constants()).to(dev)
        killed = raster.cull_meshlets(ti, mats, (*r_s._meshlet_table, cam))
        budgets(f"sphere field {SMALL_FIELD_TRIS}, supersample=2, "
                "meshlet_cull", killed, tf, pw, ph)
        if raster.select_raster("auto", ti.shape[0]) is not \
                raster.rasterize_setup_binned_hbm:
            raise AssertionError("the small field's frame does not run K4")
        compare("k4", f"sphere field {SMALL_FIELD_TRIS}, supersample=2 and "
                "meshlet_cull", k4, raster.raster_binned_plain,
                raster.prepare_binned_hbm_inputs(killed, tf, pw, ph), pw, ph)

    @phase("5e engine API: vertex shaders, mesh and compute pipelines, "
           "debug")
    def engine_api():
        scene_md = load_test_scene()
        moved_md = host_moved(scene_md)
        tex = checker_texture()
        makers = {
            "flat": (lambda md: flat_renderer(md), {"k1"}),
            "lit": (lambda md: lit_renderer(md, texture=tex), {"k2g"}),
            "shadowed": (lambda md: shadow_renderer(md), {"k2d", "k2g"}),
            "deferred": (lambda md: deferred_renderer(
                md, baseline_lights("wide")), {"k2g", "k7"}),
        }
        for name, (make, want) in makers.items():
            r = make(scene_md)
            base = r.render_and_read()
            base_map = r._shadow_map
            r.set_vertex_shader(shift_x, name="shift-x")
            shaded, launched = launched_in(r.render_and_read)
            expect_launches(f"test scene {name} {WIDTH}x{HEIGHT} with the "
                            "shader", launched, want)
            moved = make(moved_md)
            same = True
            depth_only = passes._depth_only
            if name == "shadowed":
                # The shadow pass runs no shader (as the reference's): the
                # map is the unshaded frame's, and the moved scene's frame,
                # in the frustum of the bound buffers, is lit by that map.
                same = torch.equal(r._shadow_map, base_map)
                moved._static_light_vp = r._light_view_proj()
                passes._depth_only = lambda *args, **kw: base_map
            try:
                ref = moved.render_and_read()
            finally:
                passes._depth_only = depth_only
            same = same and same_frame(shaded, ref)
            r.set_vertex_shader(None)
            restored = same_frame(r.render_and_read(), base)
            cov = (shaded[1] < 1.0).mean()
            print(f"    equal to the host-moved scene's frame {same}, "
                  f"unbound equal to the unshaded frame {restored}, "
                  f"coverage {cov:.4f}, differs from unshaded "
                  f"{not same_frame(shaded, base)}")
            if not (same and restored) or cov <= MIN_COVERAGE:
                raise AssertionError(f"{name}: the shaded frame is not the "
                                     "host-moved scene's")

        lattice_big = make_stress_scene(LARGE_TRIS)
        r = flat_renderer(lattice_big)
        column, launched = launched_in(r.render_and_read)
        expect_launches("lattice1M, column path", launched, {"k4"})
        t_col = frame_time(r.render)
        r.set_vertex_shader(lambda p, a: (p, a), name="identity")
        ident, launched = launched_in(r.render_and_read)
        expect_launches("lattice1M, identity shader (indexed entry)",
                        launched, {"k4"})
        r.set_vertex_shader(shift_x, name="shift-x")
        shifted, launched = launched_in(r.render_and_read)
        expect_launches("lattice1M, shift shader", launched, {"k4"})
        t_shader = frame_time(r.render)
        print(f"    identity shader equal to the column path "
              f"{same_frame(ident, column)}; shift shader coverage "
              f"{(shifted[1] < 1.0).mean():.4f}")
        if not same_frame(ident, column):
            raise AssertionError("lattice1M: the indexed entry is not the "
                                 "column path")
        print_time("lattice1M column path", t_col)
        print_time("lattice1M with the shift shader (indexed entry)",
                   t_shader)
        del r, lattice_big

        camera = make_test_scene()[0].active_camera
        rm = Renderer(RenderConfig(width=WIDTH, height=HEIGHT),
                      device=DEVICE)
        handle = rm.create_mesh_pipeline(grid_geometry)
        rb = flat_renderer(grid_scene(camera))
        mats = torch.from_numpy(rb.camera_matrices()).to(dev)
        pipe = rm.pipelines.lookup_pipeline(handle)
        pipe.geometry()  # warm-up
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda.set_sync_debug_mode("error")
        try:
            geometry = pipe.geometry()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        end.record()
        end.synchronize()
        gen_ms = start.elapsed_time(end)
        def syncs_in(fn):
            """fn's result and the synchronising operations torch's sync
            debug mode reports in it."""
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = fn()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            return out, sum("synchroniz" in str(w.message) for w in caught)

        (mesh_frame, launched), syncs = syncs_in(
            lambda: launched_in(lambda: rm.dispatch(handle, mats)))
        _, buffer_syncs = syncs_in(rb.render)
        expect_launches(f"mesh pipeline, {2 * MESH_QUADS ** 2} generated "
                        "triangles", launched, {"k4"})
        mesh_frame = tuple(x.cpu().numpy() for x in mesh_frame)
        buffer_frame = rb.render_and_read()
        same = same_frame(mesh_frame, buffer_frame)
        cov = (mesh_frame[1] < 1.0).mean()
        print(f"    generator and padding {gen_ms:.4f} ms (CUDA events) with "
              f"no synchronisation (sync debug mode 'error'), padded to "
              f"{[tuple(x.shape) for x in geometry]}; the whole dispatch "
              f"synchronised {syncs} times, a render of the same buffers "
              f"through load_scene {buffer_syncs} times; equal to that "
              f"frame {same}, coverage {cov:.4f}")
        if not same or cov <= MIN_COVERAGE:
            raise AssertionError("mesh pipeline frame differs from the "
                                 "buffer path's")
        print_time("mesh pipeline frame (generator, padding, K4)",
                   frame_time(lambda: rm.dispatch(handle, mats)))
        rm.destroy_pipeline(handle)
        del rb, geometry

        gen = torch.Generator(device=dev).manual_seed(3)
        texture = torch.rand((2048, 2048, 4), device=dev, generator=gen)
        hc = rm.create_compute_pipeline(generate_mip_chain)
        chain = rm.dispatch(hc, texture)
        direct = generate_mip_chain(texture)
        same = len(chain) == len(direct) == 12 and all(
            torch.equal(a, b) for a, b in zip(chain, direct))
        rm.destroy_pipeline(hc)
        try:
            rm.dispatch(hc, texture)
            stale = False
        except RuntimeError as e:
            stale = "stale" in str(e)
        print(f"  compute pipeline: generate_mip_chain of a 2048^2 texture, "
              f"{len(chain)} levels equal to a direct call {same}; dispatch "
              f"after destroy_pipeline raises {stale}")
        if not (same and stale):
            raise AssertionError("compute pipeline dispatch")

        rd = Renderer(RenderConfig(width=WIDTH, height=HEIGHT, debug=True),
                      device=DEVICE)
        rd.load_scene(*scene_md)
        debug_frame, launched = launched_in(rd.render_and_read)
        expect_launches("debug frame", launched, {"k1"})
        same = same_frame(debug_frame, flat_renderer(scene_md)
                          .render_and_read())
        color, depth = rd._pending
        bad = depth.clone()
        bad[HEIGHT // 2, WIDTH // 2] = float("nan")
        try:
            rd._validate_frame(color, bad)
            raised = False
        except FloatingPointError:
            raised = True
        print(f"    debug frame passed validation, equal to the frame "
              f"without debug {same}, clip drops {rd.stats.clip_dropped}; a "
              f"NaN depth raises FloatingPointError {raised}")
        if not (same and raised):
            raise AssertionError("debug layer")

    @phase("5f SSAA and meshlet culling")
    def frame_options():
        scene_md = load_test_scene()
        rs = flat_renderer(scene_md, supersample=2)
        img, launched = launched_in(rs.render_and_read)
        expect_launches(f"test scene supersample=2 at {WIDTH}x{HEIGHT} "
                        f"(rendered {2 * WIDTH}x{2 * HEIGHT})", launched,
                        {"k1"})
        rb = Renderer(RenderConfig(width=2 * WIDTH, height=2 * HEIGHT),
                      device=DEVICE)
        rb.load_scene(*scene_md)
        big = rb.render_and_read()
        card_res = [x.cpu().numpy() for x in raster.ssaa_resolve(
            *(torch.from_numpy(x).to(dev) for x in big), 2)]
        host_res = [x.numpy() for x in raster.ssaa_resolve(
            *(torch.from_numpy(x) for x in big), 2)]
        cam = scene_md[0].active_camera
        moved = Camera(position=cam.position + np.float32([0.5, 0.2, -0.4]),
                       forward=cam.forward, yfov=cam.yfov, znear=cam.znear,
                       zfar=cam.zfar)
        digests, _ = rs.render_animation(cameras=[cam, moved])
        want = [rgba_digest(rs.render(camera=c)[0]).item()
                for c in (cam, moved)]
        ok = (same_frame(img, card_res) and same_frame(card_res, host_res)
              and digests.tolist() == want and want[0] != want[1])
        print(f"    equal to the resolve of the {2 * WIDTH}x{2 * HEIGHT} "
              f"frame {same_frame(img, card_res)}, the card's resolve equal "
              f"to the host's {same_frame(card_res, host_res)}, "
              f"render_animation digests {digests.tolist()} equal to the "
              f"resolved frames' {want}")
        if not ok:
            raise AssertionError("SSAA frame")
        print_time("test scene supersample=2", frame_time(rs.render))
        print_time("test scene supersample=1", frame_time(
            flat_renderer(scene_md).render))

        field = make_sphere_field(LARGE_TRIS)
        r_off = flat_renderer(field)
        r_on = flat_renderer(field, meshlet_cull=True)
        off, launched = launched_in(r_off.render_and_read)
        expect_launches("sphere field 1M, no cull", launched, {"k4"})
        on, launched = launched_in(r_on.render_and_read)
        expect_launches("sphere field 1M, meshlet_cull", launched, {"k4"})
        keep, host_keep = keep_share(r_on)
        npx = WIDTH * HEIGHT
        d_diff = int((on[1] != off[1]).sum())
        c_diff = int((on[0] != off[0]).any(-1).sum())
        (ti, tf), _ = target_rows(r_on)
        kill = torch.cat([
            torch.repeat_interleave(~host_keep, tg.RASTER_BLOCK),
            torch.zeros(ti.shape[0] - host_keep.numel() * tg.RASTER_BLOCK,
                        dtype=torch.bool)])
        killed = raster.kill_rows(ti.cpu(), kill).to(dev)
        packed, depth = raster.select_raster("auto", ti.shape[0])(
            killed, tf, PAD_W, PAD_H)
        host_killed = (raster.unpack_rgba8(packed[:HEIGHT, :WIDTH]).cpu()
                       .numpy(), depth[:HEIGHT, :WIDTH].cpu().numpy())
        same = same_frame(on, host_killed)
        print(f"    kept {int(keep.sum())} of {keep.numel()} meshlets "
              f"({keep.float().mean().item():.4f}), the card's keep mask "
              f"equal to the host's {torch.equal(keep.cpu(), host_keep)}; "
              f"against the unculled frame {d_diff} depth and {c_diff} colour "
              f"pixels differ (bound {max(2, npx // 1000)}); equal to the "
              f"kernel frame of the rows killed on the host {same}; "
              f"coverage {(on[1] < 1.0).mean():.4f}")
        if (not same or not torch.equal(keep.cpu(), host_keep)
                or max(d_diff, c_diff) > max(2, npx // 1000)
                or bool(keep.all())):
            raise AssertionError("meshlet-culled frame")
        print_time("sphere field 1M without meshlet_cull",
                   frame_time(r_off.render))
        print_time("sphere field 1M with meshlet_cull",
                   frame_time(r_on.render))
        del r_off

        r_c = flat_renderer(field, supersample=2, meshlet_cull=True)
        (ti, tf), mats = target_rows(r_c)
        w, h, ph, pw = r_c._flat_target()
        dropped = r_c.clip_overflow(mats)
        budgets("sphere field 1M, supersample=2, meshlet_cull", ti, tf, pw,
                ph)
        if dropped:
            raise ValueError(f"the capped clipper drops {dropped} rows at "
                             f"{w}x{h}")
        both, launched = launched_in(r_c.render_and_read)
        expect_launches(f"sphere field 1M, supersample=2 and meshlet_cull "
                        f"(K4 at {pw}x{ph})", launched, {"k4"})
        packed, depth = raster.select_raster("auto", ti.shape[0])(
            ti, tf, pw, ph)
        unculled = [x.cpu().numpy() for x in raster.ssaa_resolve(
            raster.unpack_rgba8(packed[:h, :w]), depth[:h, :w], 2)]
        d_diff = int((both[1] != unculled[1]).sum())
        c_diff = int((both[0] != unculled[0]).any(-1).sum())
        print(f"    against the unculled resolved frame {d_diff} depth and "
              f"{c_diff} colour pixels differ (bound {max(2, npx // 1000)}),"
              f" clip drops {dropped}, coverage {(both[1] < 1.0).mean():.4f}")
        if max(d_diff, c_diff) > max(2, npx // 1000):
            raise AssertionError("supersampled culled frame")
        print_time("sphere field 1M with supersample=2 and meshlet_cull",
                   frame_time(r_c.render))

    # -- 7t. the app's trace ----------------------------------------------
    @phase("7t app --debug --trace")
    def app_trace():
        """The app with --debug --trace on the test scene for 3 frames: the
        trace names the load_scene, render and present zones and three
        frame spans, and each frame's K1 kernel lies inside a render zone
        and was launched inside one."""
        with tempfile.TemporaryDirectory() as tmp:
            rc = app_main(["--scene", SCENE_DIR, "--width", str(WIDTH),
                           "--height", str(HEIGHT), "--frames", "3",
                           "--device", DEVICE, "--debug", "--trace", tmp])
            paths = glob.glob(os.path.join(tmp, "*.json"))
            if rc != 0 or len(paths) != 1:
                raise AssertionError("--trace wrote no trace")
            with open(paths[0]) as f:
                events = [e for e in json.load(f)["traceEvents"]
                          if e.get("ph") == "X"]
        def spans(name, cats):
            return [(e["ts"], e["ts"] + e["dur"]) for e in events
                    if e["name"] == name and e.get("cat") in cats]
        cpu = ("user_annotation",)
        zones = {z: len(spans(z, cpu))
                 for z in ("load_scene", "render", "present", "frame")}
        renders = spans("render", cpu) + spans("render",
                                               ("gpu_user_annotation",))
        k1_events = [e for e in events if e.get("cat") == "kernel"
                     and "raster_small_kernel" in e["name"]]
        launch_ts = {e["args"].get("correlation"): e["ts"] for e in events
                     if e.get("cat") in ("cuda_runtime", "cuda_driver")}
        inside = sum(any(a <= e["ts"] and e["ts"] + e["dur"] <= b
                         for a, b in renders) for e in k1_events)
        launched_inside = sum(
            any(a <= launch_ts.get(e["args"].get("correlation"), -1) <= b
                for a, b in spans("render", cpu)) for e in k1_events)
        print(f"  app test scene flat --debug --trace, 3 frames: rc={rc}, "
              f"zones {zones}, {len(k1_events)} K1 kernel events, "
              f"{inside} inside a render zone, {launched_inside} launched "
              f"inside one")
        if (zones["load_scene"] != 1 or zones["render"] != 3
                or zones["present"] != 3 or zones["frame"] != 3
                or len(k1_events) != 3 or inside != 3
                or launched_inside != 3):
            raise AssertionError("--trace: zones, frame spans or K1 events "
                                 "missing")

    @phase("6a showcase frames traced, glTF against bins")
    def asset_traces():
        """Phase 5a's lit and shadowed 1080p showcase renderers, loaded
        from the glTF and from the bins: one traced frame each."""
        for label, of in asset_renderers.items():
            for name, r in of.items():
                events, _ = device_trace(r.render)
                print(f"  showcase {label} 1080p from {name}: "
                      f"{busy_us(events) / 1000.0:.4f} ms busy a frame "
                      f"({len(events)} device ops, one traced frame)")

    @phase("6x experiment kernel timing")
    def experiment_timing():
        """Each kernel's device time from a trace holding all its launches
        at its main shape (the 1M lattice for the flat kernels, its lit
        rows for the G-buffer ones, the 20K lattice's map for K10g8d), its
        entry point traced once (prepare and launch: device ops, busy, idle
        share), then the untraced launcher and prepare loops and the
        bounds; the G-buffer kernels also on the lit 40K lattice and the
        test scene.  Each kernel, on the keyed body: a call is the sum of
        its device ops (``call_ops``), whose count the trace must hold,
        each op's time printed; the entry point's trace
        split into the prepare's ops and the kernel's (``entry_split``);
        ptxas's registers, spills and shared memory of the item, resolve
        and hit-word kernels; the bound by ``x_work``."""
        S = SHADOW_SIZE
        lit = lit_rows_1m()
        main = {  # key: (rows, shape, (w, h), reps, entry point)
            "k10g8": (rows_1m, "lattice1M", (PAD_W, PAD_H), 5,
                      group8.rasterize_setup_group8),
            "k10vec": (rows_1m, "lattice1M", (PAD_W, PAD_H), 5,
                       vec.rasterize_setup_vec),
            "k10g8g": (lit, "lit lattice1M", (PAD_W, PAD_H), 5,
                       group8.rasterize_gbuffer_group8),
            "k10vecg": (lit, "lit lattice1M", (PAD_W, PAD_H), 5,
                        vec.rasterize_gbuffer_vec),
            "k10g8d": (x_map20, "lattice20k map", (S, S), 20,
                       group8.rasterize_depth_group8),
        }
        preps = {}
        for key, (rows, shape, (w, h), reps, fn) in main.items():
            kern, _, prepare, _ = x_cases[key]
            prep = preps[key] = prepare(*rows, w, h)
            events, _, ms = traced_kernel_ms(
                (key,), lambda: [kern(*prep, w, h) for _ in range(reps)])
            results[key]["ms"] = ms[key]
            keyed = key in x_resolve_names
            if keyed:
                ops = call_ops(key)
                per_op = {o: sum(d for n, _, d in events if o in n) / reps
                          / 1000.0 for o in ops}
                results[key].update(device_ops_per_call=len(ops),
                                    op_ms=per_op)
                print(f"  {key}: {len(events)} device ops for {reps} calls "
                      f"in its trace ({len(ops)} a call: {', '.join(ops)}; "
                      f"{x_items(key)} work items a tile); {ms[key]:.4f} ms "
                      "a call (their sum; each op: "
                      + ", ".join(f"{o} {t:.4f}" for o, t in per_op.items())
                      + ")")
                if len(events) != len(ops) * reps:
                    raise AssertionError(f"{key}: {len(events)} device ops "
                                         f"for {reps} calls, not "
                                         f"{len(ops)} a call")
            events, window, kms = traced_kernel_ms(
                (key,), lambda: fn(*rows, w, h))
            results[key]["anim_ms"] = kms[key]
            busy = busy_us(events)
            split = ""
            if keyed:
                (n_pre, pre_ms), (n_k, k_ms), _ = entry_split(key, events)
                results[key].update(entry_ops=len(events),
                                    entry_busy_ms=busy / 1000.0,
                                    entry_idle_share=1.0 - busy / window,
                                    entry_prepare_ms=pre_ms,
                                    entry_kernel_ms=k_ms)
                split = (f"; split (device ms, summed): prepare {n_pre} ops "
                         f"{pre_ms:.4f}, kernel {n_k} ops {k_ms:.4f}")
            print(f"  profiled entry point {fn.__name__} on {shape} {w}x{h}:"
                  f" {len(events)} device ops, device busy "
                  f"{busy / 1000.0:.4f} ms ({key} {kms[key]:.4f} ms), idle "
                  f"share {1.0 - busy / window:.4f} of "
                  f"{window / 1000.0:.4f} ms traced{split}", flush=True)
        preps40 = {}
        for key in ("k10g8g", "k10vecg"):
            kern, _, prepare, _ = x_cases[key]
            prep = preps40[key] = prepare(*x_lit40, PAD_W, PAD_H)
            events, _, ms = traced_kernel_ms(
                (key,), lambda: [kern(*prep, PAD_W, PAD_H)
                                 for _ in range(20)])
            ops = call_ops(key)
            results[key]["ms_40k"] = ms[key]
            print(f"  {key} lit lattice40k: {len(events)} device ops for 20 "
                  f"calls ({len(ops)} a call); {ms[key]:.4f} ms a call")
            if len(events) != len(ops) * 20:
                raise AssertionError(f"{key}: {len(events)} device ops for "
                                     f"20 calls, not {len(ops)} a call")
            prep = prepare(*x_scene_rows, PAD_W, PAD_H)
            _, _, ms = traced_kernel_ms(
                (key,), lambda: [kern(*prep, PAD_W, PAD_H)
                                 for _ in range(50)])
            results[key]["ms_test_scene"] = ms[key]
        # Untraced: launchers, prepares, bounds.
        for key, (rows, shape, (w, h), reps, _) in main.items():
            kern = x_cases[key][0]
            prep = preps[key]
            res = results[key]
            res["wrapper_ms"] = event_ms(lambda: kern(*prep, w, h), reps)
            if key.startswith("k10g8"):
                used = int(prep.offs[-1].item())
                inputs = [prep.offs, prep.tile_any, prep.rows[:used],
                          prep.megas, prep.supers, prep.blocks, prep.hier,
                          prep.hier_f]
                tile = (group8.GT_H, group8.GT_W)
            else:  # each subgroup is gated per 8-row chunk of a tile
                inputs, tile = list(prep), (vec.CHUNK_H, raster.TILE_W)
            planes = (raster.GBUFFER_PLANES if key.endswith("g")
                      else 1 if key.endswith("d") else 2)
            work = {}
            if key in x_resolve_names:
                admitted, evals, nbytes = x_work(key, prep, w, h)
                work = dict(evals=evals, nbytes=nbytes)
                res["admitted"] = admitted
                names = (kernel_names[key], x_resolve_names[key],
                         hit_words_names[key])
                res["registers"] = ptxas_entry(names[0], PTXAS_REGISTERS)
                print(f"  {key} {shape}: {admitted} admitted (tile, row) "
                      "pairs and list entries; ptxas: " + "; ".join(
                          f"{n} {ptxas_entry(n, PTXAS_REGISTERS)} registers, "
                          f"{ptxas_entry(n, PTXAS_SPILLS)} bytes spilled, "
                          f"{ptxas_entry(n, PTXAS_SMEM)} bytes of static "
                          "shared memory" for n in names)
                      + f"; {res.get('smem_bytes')} bytes of dynamic shared "
                      "memory an item")
            set_bound(key, inputs, tile_pairs(rows[0], w, h, *tile), w, h,
                      shape, planes=planes, tile_px=tile[0] * tile[1],
                      **work)
            extra = ""
            if "ms_test_scene" in res:
                extra = f", test scene {res['ms_test_scene']:.4f} ms"
            print(f"  {key} {shape} {w}x{h} ({tile[0]}x{tile[1]} pairs): "
                  f"kernel {res['ms']:.4f} ms device time (profiler{extra};"
                  f" {res['anim_ms']:.4f} ms in the traced entry point), "
                  f"launcher {res['wrapper_ms']:.4f} ms/call (CUDA events);"
                  f" plain version {res['plain_ms']:.4f} ms/call at "
                  f"{res['plain_shape']} (CUDA events)")
        for key, prep in preps40.items():
            kern, res = x_cases[key][0], results[key]
            res["wrapper_ms_40k"] = event_ms(
                lambda: kern(*prep, PAD_W, PAD_H), 20)
            _, evals, nbytes = x_work(key, prep, PAD_W, PAD_H)
            t_ops = evals * OPS_PER_EVAL / CUDA_CORE_OPS_PER_S * 1e3
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            res.update(bound_ms_40k=max(t_ops, t_bytes), evals_40k=evals,
                       bytes_40k=nbytes)
            print(f"  {key} lit lattice40k {PAD_W}x{PAD_H}: kernel "
                  f"{res['ms_40k']:.4f} ms device time (profiler), launcher "
                  f"{res['wrapper_ms_40k']:.4f} ms/call (CUDA events); bound "
                  f"{res['bound_ms_40k']:.4f} ms (operations {t_ops:.4f}: "
                  f"{evals} window pixel evaluations; bytes {t_bytes:.4f}: "
                  f"{nbytes})")
        ti, tf = rows_1m
        g8_ms = event_ms(lambda: group8.prepare_group8_inputs(
            ti, tf, PAD_W, PAD_H), 5)
        vec_ms = event_ms(lambda: vec.prepare_vec_inputs(ti, tf), 5)
        results["k10g8"]["prepare_ms"] = g8_ms
        results["k10vec"]["prepare_ms"] = vec_ms
        print(f"  prepares on lattice1M ({ti.shape[0]} rows): "
              f"prepare_group8_inputs (sort, gather, tables) {g8_ms:.4f} "
              f"ms/call, prepare_vec_inputs (record build) {vec_ms:.4f} "
              "ms/call (CUDA events, host dispatch included)")

    # -- 6xv. the visibility-buffer traces ----------------------------------
    # Taken here, before phase 6's untraced loops and the plain versions of
    # 4xv and 5xv: a trace after about 1.2M untraced launches loses one
    # kernel record (tools/profiler_probe.py), and traced_kernel_ms then
    # refuses it.
    vt_cases = {  # key: (kernel, plain version, entry point, prepare)
        "k10vis": (kxvis, vis_trans.raster_vis_plain,
                   vis_trans.rasterize_setup_vis,
                   vis_trans.prepare_vis_inputs),
        "k10trans": (kxtrans, vis_trans.raster_trans_plain,
                     vis_trans.rasterize_setup_trans,
                     lambda ti, tf, w, h: vis_trans.prepare_trans_inputs(
                         ti, tf)),
    }

    @phase("6xv K10vis/K10trans traces")
    def vis_traces():
        """Each kernel's device time from a trace at 1M (five launches: a
        call is the sum of its device ops, ``call_ops``, whose count the
        trace must hold), each entry point traced once (device ops, busy,
        idle share and its split into prepare, kernel and resolve,
        ``entry_split``) and the resolve traced once.  Returns the 1M
        prepares, the planes of K10vis with the table, and the resolve's
        busy ms."""
        ti, tf = rows_1m
        w, h = PAD_W, PAD_H
        preps = {}
        for key, (kern, _, fn, prepare) in vt_cases.items():
            *args, table = preps[key] = prepare(ti, tf, w, h)
            reps = 5
            events, _, ms = traced_kernel_ms(
                (key,), lambda: [kern(*args, w, h) for _ in range(reps)])
            results[key]["ms"] = ms[key]
            ops = call_ops(key)
            results[key]["device_ops_per_call"] = len(ops)
            names = sorted({n.split("(")[0] for n, _, _ in events})
            per_op = {o: sum(d for n, _, d in events if o in n) / reps
                      / 1000.0 for o in ops}
            results[key]["op_ms"] = per_op
            print(f"  {key}: {len(events)} device ops for {reps} calls in "
                  f"its trace ({len(ops)} a call: {', '.join(ops)}): "
                  f"{names}; {ms[key]:.4f} ms a call (their sum; each op: "
                  + ", ".join(f"{o} {t:.4f}" for o, t in per_op.items())
                  + ")")
            if len(events) != len(ops) * reps:
                raise AssertionError(f"{key}: {len(events)} device ops for "
                                     f"{reps} calls, not {len(ops)} a call")
            events, window, kms = traced_kernel_ms((key,),
                                                   lambda: fn(ti, tf, w, h))
            busy = busy_us(events)
            (n_pre, pre_ms), (n_k, k_ms), (n_res, res_ms) = entry_split(
                key, events)
            results[key].update(anim_ms=kms[key], entry_ops=len(events),
                                entry_busy_ms=busy / 1000.0,
                                entry_idle_share=1.0 - busy / window,
                                entry_prepare_ms=pre_ms,
                                entry_kernel_ms=k_ms,
                                entry_resolve_ms=res_ms)
            print(f"  profiled entry point {fn.__name__} on lattice1M {w}x"
                  f"{h}: {len(events)} device ops, device busy "
                  f"{busy / 1000.0:.4f} ms ({key} {kms[key]:.4f} ms), idle "
                  f"share {1.0 - busy / window:.4f} of "
                  f"{window / 1000.0:.4f} ms traced; kernel alone "
                  f"{ms[key]:.4f} ms; split (device ms, summed): prepare "
                  f"{n_pre} ops {pre_ms:.4f}, kernel {n_k} ops {k_ms:.4f}, "
                  f"resolve {n_res} ops {res_ms:.4f}", flush=True)
        *args, table = preps["k10vis"]
        depth, idx = kxvis(*args, w, h)
        events, window = device_trace(
            lambda: vis_trans.resolve_flat_vis(depth, idx, table))
        busy = busy_us(events)
        print(f"  resolve_flat_vis on lattice1M {w}x{h}: {len(events)} "
              f"device ops, device busy {busy / 1000.0:.4f} ms of "
              f"{window / 1000.0:.4f} ms traced")
        return preps, (depth, idx, table), busy / 1000.0

    def vis_inputs_1m():
        """The 1M prepares, K10vis's planes with the table and the
        resolve's busy ms: 6xv's, or where ``--phases`` skipped its traces,
        new ones (the resolve's busy time then not measured)."""
        if vis_traces is not None:
            return vis_traces
        preps = {key: case[3](*rows_1m, PAD_W, PAD_H)
                 for key, case in vt_cases.items()}
        *args, table = preps["k10vis"]
        return preps, (*kxvis(*args, PAD_W, PAD_H), table), None

    # -- 6h. the two-class traces -------------------------------------------
    # Before phase 6's untraced loops and the plain versions, as 6xv's.
    th_cases = {  # key: (kernel, plain version, entry point, prepare)
        "k10hbm2": (kxh2, hbm2.raster_hbm2_plain, hbm2.rasterize_setup_hbm2,
                    lambda ti, tf, h: hbm2.prepare_raster_inputs_2class(
                        ti, tf)),
        "k10scan": (kxscan, scanline.raster_scanline_plain,
                    scanline.rasterize_setup_scanline,
                    scanline.prepare_scanline_inputs),
    }
    @phase("6h K10hbm2/K10scan traces")
    def twoclass_traces():
        """Each kernel's device time from a trace at 1M (five launches: a
        call is the sum of its device ops, ``call_ops``, whose count the
        trace must hold) and each entry point traced once (device ops,
        busy, idle share).  Returns the 1M prepares."""
        ti, tf = rows_1m
        w, h = PAD_W, PAD_H
        preps = {}
        for key, (kern, _, fn, prepare) in th_cases.items():
            args = preps[key] = prepare(ti, tf, h)
            reps = 5
            events, _, ms = traced_kernel_ms(
                (key,), lambda: [kern(*args, w, h) for _ in range(reps)])
            results[key]["ms"] = ms[key]
            ops = call_ops(key)
            results[key]["device_ops_per_call"] = len(ops)
            names = sorted({n.split("(")[0] for n, _, _ in events})
            per_op = {o: sum(d for n, _, d in events if o in n) / reps
                      / 1000.0 for o in ops}
            results[key]["op_ms"] = per_op
            print(f"  {key}: {len(events)} device ops for {reps} calls in "
                  f"its trace ({len(ops)} a call: {', '.join(ops)}): "
                  f"{names}; {ms[key]:.4f} ms a call (their sum; each op: "
                  + ", ".join(f"{o} {t:.4f}" for o, t in per_op.items())
                  + ")")
            if len(events) != len(ops) * reps:
                raise AssertionError(f"{key}: {len(events)} device ops for "
                                     f"{reps} calls, not {len(ops)} a call")
            events, window, kms = traced_kernel_ms((key,),
                                                   lambda: fn(ti, tf, w, h))
            busy = busy_us(events)
            results[key].update(anim_ms=kms[key], entry_ops=len(events),
                                entry_busy_ms=busy / 1000.0,
                                entry_idle_share=1.0 - busy / window)
            print(f"  profiled entry point {fn.__name__} on lattice1M {w}x"
                  f"{h}: {len(events)} device ops, device busy "
                  f"{busy / 1000.0:.4f} ms ({key} {kms[key]:.4f} ms), idle "
                  f"share {1.0 - busy / window:.4f} of "
                  f"{window / 1000.0:.4f} ms traced; kernel alone "
                  f"{ms[key]:.4f} ms", flush=True)
        return preps

    # The 1M prepares: 6h's, or where ``--phases`` skipped it, new ones.
    th_preps = twoclass_traces or {
        key: case[3](*rows_1m, PAD_H) for key, case in th_cases.items()}

    @phase("6 timing")
    def timing():
        # (label, renderer, kernels timed in its trace, frames timed,
        # frames profiled)
        animations = (
            ("test scene (K1)", r_scene, ("k1",), ANIM_FRAMES,
             PROFILE_FRAMES),
            ("lattice (K3)", r_lattice, ("k3",), ANIM_FRAMES, PROFILE_FRAMES),
            ("lattice1M (K4)", r_k4, ("k4",), LARGE_FRAMES, 5),
            ("lattice1M (K5)", r_k5, ("k5",), LARGE_FRAMES, 5),
            ("soup1M tile_lists (K4c)", r_k4c, ("k4_coarse",), 5, 3),
            ("lattice20k tile_lists (K6)", r_k6, ("k6",), ANIM_FRAMES,
             PROFILE_FRAMES),
            ("lit test scene (K2g)", r_lit, ("k2g",), ANIM_FRAMES,
             PROFILE_FRAMES),
            ("lit lattice20k (K3g)", r_lit3, ("k3g",), ANIM_FRAMES,
             PROFILE_FRAMES),
            ("lit lattice1M (K4g)", r_lit4, ("k4g",), LARGE_FRAMES, 5),
            ("lit lattice1M (K5g)", r_lit5, ("k5g",), LARGE_FRAMES, 5),
            ("shadowed test scene (K2d, K2g)", r_sh, ("k2d",), ANIM_FRAMES,
             PROFILE_FRAMES),
            ("shadowed lattice20k (K3d, K3g)", r_sh3, ("k3d",), ANIM_FRAMES,
             PROFILE_FRAMES),
            ("shadowed lattice20k tile_lists (K6d, K6g)", r_sh6,
             ("k6d", "k6g"), ANIM_FRAMES, PROFILE_FRAMES),
            ("shadowed lattice1M (K4d, K4g)", r_sh4, ("k4d",), LARGE_FRAMES,
             5),
            ("deferred test scene wide (K2g, K7)", r_def, ("k7",),
             ANIM_FRAMES, PROFILE_FRAMES),
            ("deferred test scene r2 (K2g, K7)", r_def_r2, ("k7",),
             ANIM_FRAMES, PROFILE_FRAMES),
            ("deferred test scene wide bf16 planes (K2g, K7 bf16)",
             r_def_bf16, ("k7_bf16",), ANIM_FRAMES, PROFILE_FRAMES),
        )
        # A. Traces: each kernel alone at its main-path shape, a profiled
        # render_animation per path, and the device ops of each stage.
        # The depth kernels run at the shadow map's size, the rest at the
        # padded frame's.
        S = SHADOW_SIZE
        size_of = {k: (S, S) for k in ("k2d", "k3d", "k4d", "k6d")}
        rows_k6g, rows_k6d = lit_frame_rows(r_sh6), light_rows(r_sh6)
        cases = {
            "k1": (k1_inputs, "test scene", 50),
            "k3": (main_prep_k3, "lattice20k", 20),
            "k4": (raster.prepare_binned_hbm_inputs(*rows_lattice, PAD_W,
                                                    PAD_H), "lattice1M", 5),
            "k5": (raster.prepare_raster_inputs(*rows_lattice), "lattice1M",
                   10),
            "k4_coarse": (raster.prepare_binned_hbm_inputs(
                *rows_soup, PAD_W, PAD_H,
                coarse_cap=raster.TILE_LISTS_COARSE_CAP), "soup1M", 3),
            "k6": (raster.prepare_binned_inputs(*rows_k6, PAD_W, PAD_H),
                   "lattice20k", 20),
            "k2g": (raster.prepare_binned_small(*lit_frame_rows(r_lit),
                                                PAD_W, PAD_H),
                    "test scene", 50),
            "k3g": (raster.prepare_raster_inputs(*lit_frame_rows(r_lit3)),
                    "lattice20k", 20),
            "k4g": (raster.prepare_binned_hbm_inputs(*rows_lit_big, PAD_W,
                                                     PAD_H), "lattice1M", 5),
            "k5g": (raster.prepare_raster_inputs(*rows_lit_big), "lattice1M",
                    10),
            "k6g": (raster.prepare_binned_inputs(*rows_k6g, PAD_W, PAD_H),
                    "lattice20k", 20),
            "k2d": (raster.prepare_binned_small(*light_rows(r_sh), S, S),
                    "test scene", 50),
            "k3d": (raster.prepare_raster_inputs(*light_rows(r_sh3)),
                    "lattice20k", 20),
            "k4d": (raster.prepare_binned_hbm_inputs(*rows_sh_big, S, S),
                    "lattice1M", 5),
            "k6d": (raster.prepare_binned_inputs(*rows_k6d, S, S),
                    "lattice20k", 20),
        }
        for key, (prep_k, shape, reps) in cases.items():
            kern = kernel_of[key]
            w, h = size_of.get(key, (PAD_W, PAD_H))
            events, _, ms = traced_kernel_ms(
                (key,), lambda: [kern(*prep_k, w, h) for _ in range(reps)])
            results[key]["ms"] = ms[key]
            if key in resolve_names or key in hier_resolve_names:
                ops = len(call_ops(key))
                results[key]["device_ops_per_call"] = ops
                names = sorted({n.split("(")[0] for n, _, _ in events})
                print(f"  {key}: {len(events)} device ops for {reps} calls "
                      f"in its trace: {names}")
                if len(events) != ops * reps:
                    raise AssertionError(f"{key}: {len(events)} device ops "
                                         f"for {reps} calls, not {ops} a "
                                         "call")
        # K4 on soup1M through `auto`: large triangles, and the rows past
        # the record budget in the leftover walk.
        prep_soup = raster.prepare_binned_hbm_inputs(*rows_soup, PAD_W,
                                                     PAD_H)
        _, _, ms = traced_kernel_ms(
            ("k4",), lambda: [k4(*prep_soup, PAD_W, PAD_H) for _ in range(3)])
        results["k4"]["ms_soup1m"] = ms["k4"]
        # The band kernels (phase 4s/5m inputs): one launch's device time
        # at each kernel's main-path band, one card rendering the bands in
        # turn; K9 on band 0 of the 1M lattice's 2 bands, K9g on band 0 of
        # the deferred test scene's, K3b on the 20K lattice's (the test
        # scene's band is too small to show the walk), K9d on the 40K
        # lattice's.
        band_prep = dict(band_cases)
        s_rows = {}
        dargs = deferred_band_refs["wide"][0]
        _, ti_d, tf_d, s_d = tiles.setups_in_turn(
            2, *dargs[:5], PAD_W, H2, normal_matrices=dargs[5],
            material_table=dargs[6])
        _, ti_m, tf_m, s_m = tiles.setups_in_turn(
            2, *indexed_args(r_k4, H2), PAD_W, H2)

        def band_prepare(ti, tf, s):
            return raster.prepare_binned_hbm_inputs(
                ti, tf, PAD_W, H2, n_head=2 * s,
                pair_budget=raster.band_pair_budget(2), band_ty0=0,
                band_tiles_y=H2 // 2 // raster.TILE_H)

        band_prep["k9"] = (band_prepare(ti_m, tf_m, s_m), 0, 544,
                           "lattice1M band 0 of 2", band_pairs(ti_m, 0, 544))
        band_prep["k9g"] = (band_prepare(ti_d, tf_d, s_d), 0, 544,
                            "deferred test scene band 0 of 2",
                            band_pairs(ti_d, 0, 544))
        s_rows.update(k9=(ti_m, tf_m, s_m), k9g=(ti_d, tf_d, s_d))
        band_reps = {"k3b": 20, "k9": 5, "k9g": 50, "k9d": 20}
        for key, (prep_k, r0, bh, shape, _) in band_prep.items():
            kern = kernel_of[key]
            _, _, ms = traced_kernel_ms(
                (key,), lambda: [kern(*prep_k, PAD_W, bh, r0)
                                 for _ in range(band_reps[key])])
            results[key]["ms"] = ms[key]
        # One sharded frame of each band kernel's main path, every band in
        # turn on this card (not a multi-card time): device ops, busy and
        # each kernel's time a launch.
        band_frames = {
            "k3b": ("flat test scene, 2 bands (K3b)",
                    lambda: tiles.bands_in_turn(
                        2, WIDTH, H2, *indexed_args(r_scene, H2))),
            "k9": ("lattice1M, 2 bands (K9)",
                   lambda: tiles.bands_in_turn(
                       2, WIDTH, H2, *indexed_args(r_k4, H2))),
            "k9g": ("deferred test scene wide, 2 bands (K9g + K7)",
                    lambda: tiles.deferred_bands_in_turn(2, WIDTH, H2,
                                                         *dargs)),
            "k9d": ("lattice40k, 2 bands, dist (K9d)",
                    lambda: tiles.bands_in_turn(
                        2, WIDTH, H2, *indexed_args(r_lattice40, H2),
                        "dist")),
        }
        for key, (label, fn) in band_frames.items():
            events, window, kms = traced_kernel_ms((key,), fn)
            results[key]["anim_ms"] = kms[key]
            busy = busy_us(events)
            print(f"  profiled sharded frame {WIDTH}x{H2} {label}, one card "
                  f"rendering every band in turn: {len(events)} device ops, "
                  f"device busy {busy / 1000.0:.4f} ms ({key} "
                  f"{kms[key]:.4f} ms a launch), idle share "
                  f"{1.0 - busy / window:.4f} of {window / 1000.0:.4f} ms "
                  "traced")
        # K7 on the test scene's 1080p G-buffer: (key, light set, inputs).
        light_runs = [(key, name, light_cases[name, key])
                      for key in ("k7", "k7_bf16") for name in ("wide", "r2")]
        for key, name, inputs in light_runs:
            _, _, ms = traced_kernel_ms(
                (key,), lambda: [light_of[key](*inputs) for _ in range(20)])
            results[key]["ms" if name == "wide" else "ms_r2"] = ms[key]
        # K8 and K8b on the --ui windows' draw list of the 1080p test
        # scene, then one app frame of the test scene without and with the
        # overlay (rendered, composited on the card, read back).
        ov_rows = overlay_cases["ImguiOverlay"]
        _, _, ms = traced_kernel_ms(
            ("k8",), lambda: [k8(*ov_rows, WIDTH, HEIGHT) for _ in range(20)])
        results["k8"]["ms"] = ms["k8"]
        cnt8, over8, lay8 = k8(*ov_rows, WIDTH, HEIGHT)
        frame8 = r_scene.render()[0]
        _, _, ms = traced_kernel_ms(
            ("k8b",), lambda: [k8b(frame8, cnt8, lay8, atlas_dev)
                               for _ in range(20)])
        results["k8b"]["ms"] = ms["k8b"]
        def plain_frame():
            r_scene.render()
            return r_scene.read_frame()

        app_frames = {
            "without --overlay/--ui": (plain_frame, ()),
            "--overlay": (lambda: ui_o.compose(r_scene.render()[0], ui_text),
                          ("k8", "k8b")),
            "--ui": (lambda: ui_i.compose(r_scene.render()[0], stats_text,
                                          r_scene.scene), ("k8", "k8b")),
        }
        for label, (fn, keys) in app_frames.items():
            if keys:
                events, window, kms = traced_kernel_ms(keys, fn)
                if label == "--ui":  # the kernels' main shape
                    for key in keys:
                        results[key]["anim_ms"] = kms[key]
                per_kernel = ", ".join(f"{k} {kms[k]:.4f} ms" for k in keys)
            else:
                events, window = device_trace(fn)
                per_kernel = "no overlay kernel"
            busy = busy_us(events)
            print(f"  profiled app frame {WIDTH}x{HEIGHT} test scene "
                  f"{label}: {len(events)} device ops, device busy "
                  f"{busy / 1000.0:.4f} ms ({per_kernel} a launch), idle "
                  f"share {1.0 - busy / window:.4f} of "
                  f"{window / 1000.0:.4f} ms traced (read-back included)")
        for label, r, keys, _, n in animations:
            events, window, kms = traced_kernel_ms(
                keys, lambda r=r: r.render_animation(num_frames=n)[0].cpu())
            for key in keys:  # the first path of a kernel is its main one
                results[key].setdefault("anim_ms", kms[key])
            busy = busy_us(events)
            raster_us = sum(dur for name, _, dur in events
                            if any(k in name for k in port_kernels))
            per_kernel = ", ".join(f"{k} {kms[k]:.4f}" for k in keys)
            print(f"  profiled render_animation({n}) {label}: "
                  f"{len(events) / n:.1f} device ops/frame, device busy "
                  f"{busy / n / 1000.0:.4f} ms/frame (port kernels "
                  f"{raster_us / n / 1000.0:.4f}; {per_kernel} ms a "
                  f"launch), idle share {1.0 - busy / window:.4f} of "
                  f"{window / n / 1000.0:.4f} ms/frame traced (host slowed "
                  f"by the profiler)")
        n = CONFIG4_FRAMES
        events, window, kms = traced_kernel_ms(
            ("k4",), lambda: config4(r_k4, n)[0].cpu())
        busy = busy_us(events)
        print(f"  profiled config 4 ({n} frames + the first): "
              f"{len(events) / n:.1f} device ops/frame, device busy "
              f"{busy / n / 1000.0:.4f} ms/frame (K4 {kms['k4']:.4f} ms a "
              f"launch), idle share {1.0 - busy / window:.4f} of "
              f"{window / n / 1000.0:.4f} ms/frame traced")

        # Stage breakdowns: one test-scene frame (K1) and one 1M-lattice
        # frame (K4).
        b = r_scene._buffers()
        mats = torch.from_numpy(r_scene.camera_matrices()).to(dev)
        cfg = r_scene.config
        ti, tf = tg.geometry_pipeline_cols(b["corner_cols"], b["tri_node"],
                                           mats, cfg.width, cfg.height)
        prep = raster.prepare_binned_small(ti, tf, cfg.pad_width,
                                           cfg.pad_height)
        packed, _ = k1(*prep, cfg.pad_width, cfg.pad_height)
        b4 = r_k4._buffers()
        mats4 = torch.from_numpy(r_k4.camera_matrices()).to(dev)
        prep4 = cases["k4"][0]
        packed4, _ = k4(*prep4, PAD_W, PAD_H)
        stages = {
            "geometry": (lambda: tg.geometry_pipeline_cols(
                b["corner_cols"], b["tri_node"], mats, cfg.width,
                cfg.height), 50),
            "prepare_binned_small": (lambda: raster.prepare_binned_small(
                ti, tf, cfg.pad_width, cfg.pad_height), 50),
            "K1 wrapper": (lambda: k1(*prep, cfg.pad_width, cfg.pad_height),
                           50),
            "digest": (lambda: frame_digest(packed), 50),
            "lattice1M geometry": (lambda: tg.geometry_pipeline_cols(
                b4["corner_cols"], b4["tri_node"], mats4, WIDTH, HEIGHT), 10),
            "lattice1M prepare_binned_hbm_inputs":
                (lambda: raster.prepare_binned_hbm_inputs(*rows_lattice,
                                                          PAD_W, PAD_H), 10),
            "lattice1M K4 launcher": (lambda: k4(*prep4, PAD_W, PAD_H), 10),
            "lattice1M digest": (lambda: frame_digest(packed4), 10),
        }
        stages.update(lit_stages())
        stages.update(shadow_stages())
        stages.update(deferred_stages())
        stage_events = {name: device_trace(fn)[0]
                        for name, (fn, _) in stages.items()}

        # B. Untraced timing loops (no trace follows them).
        for label, r, key, frames, _ in animations:
            digests, _ = r.render_animation(num_frames=frames)  # warm-up
            sync()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            digests, _ = r.render_animation(num_frames=frames)
            end.record()
            d = digests.cpu().numpy()
            wall = (time.perf_counter() - t0) * 1000.0 / frames
            dev_ms = start.elapsed_time(end) / frames
            if not (d > 0).all() or not (d == d[0]).all():
                raise AssertionError(f"{label}: bad digests {d[:4]}")
            print(f"  render_animation {WIDTH}x{HEIGHT} {label}: "
                  f"{dev_ms:.4f} ms/frame (CUDA events), "
                  f"{1000.0 / dev_ms:.1f} FPS; host clock {wall:.4f} "
                  f"ms/frame incl. digest read; digest {d[0]:.6e}")
        config4(r_k4, CONFIG4_FRAMES)[0].cpu()  # warm-up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        digest = config4(r_k4, CONFIG4_FRAMES)[0]
        end.record()
        end.synchronize()
        ms4 = start.elapsed_time(end) / CONFIG4_FRAMES
        print(f"  config 4 {WIDTH}x{HEIGHT} (lattice1M, K4 + "
              f"taa_resolve_packed): {ms4:.4f} ms/frame (CUDA events over "
              f"{CONFIG4_FRAMES} frames and the seeding frame, divided by "
              f"{CONFIG4_FRAMES} as benchmarks/config4.py does), "
              f"{1000.0 / ms4:.1f} FPS; digest {digest.item():.6e}")
        for label, (fn, _) in app_frames.items():
            fn()
            sync()
            t0 = time.perf_counter()
            for _ in range(OVERLAY_FRAMES):
                fn()
            sync()
            ms = (time.perf_counter() - t0) * 1000.0 / OVERLAY_FRAMES
            print(f"  app frame {WIDTH}x{HEIGHT} test scene {label}: "
                  f"{ms:.4f} ms/frame (host clock over {OVERLAY_FRAMES} "
                  f"frames, each read back)")
        for name, (fn, reps) in stages.items():
            ev = stage_events[name]
            print(f"  stage {name}: {event_ms(fn, reps):.4f} ms/call "
                  f"(CUDA events, host dispatch included), {len(ev)} device "
                  f"ops/call, device busy {busy_us(ev) / 1000.0:.4f} "
                  f"ms/call (profiler)")

        # K4 on soup1M: its bound by window pixels and needed bytes.
        soup_evals, soup_bytes = keyed_work(
            prep_soup, PAD_W, PAD_H, HEIGHT, 2,
            k4(*prep_soup, PAD_W, PAD_H)[1])
        results["k4"].update(
            evals_soup1m=soup_evals, bytes_soup1m=soup_bytes,
            bound_ms_soup1m=max(
                soup_bytes / HBM_BYTES_PER_S * 1e3,
                soup_evals * OPS_PER_EVAL / CUDA_CORE_OPS_PER_S * 1e3),
            wrapper_ms_soup1m=event_ms(lambda: k4(*prep_soup, PAD_W, PAD_H),
                                       3))
        print(f"  k4 soup1M {PAD_W}x{PAD_H}: kernel "
              f"{results['k4']['ms_soup1m']:.4f} ms a call (profiler: memset,"
              f" item and resolve kernels), launcher "
              f"{results['k4']['wrapper_ms_soup1m']:.4f} ms/call (CUDA "
              f"events); {soup_evals} window pixel evaluations, "
              f"{soup_bytes} bytes; bound "
              f"{results['k4']['bound_ms_soup1m']:.4f} ms")
        rows_of = {"k4": rows_lattice, "k5": rows_lattice,
                   "k4_coarse": rows_soup, "k6": rows_k6,
                   "k4g": rows_lit_big, "k5g": rows_lit_big,
                   "k4d": rows_sh_big, "k6g": rows_k6g, "k6d": rows_k6d}
        for key, (prep_k, shape, reps) in cases.items():
            kern = kernel_of[key]
            res = results[key]
            w, h = size_of.get(key, (PAD_W, PAD_H))
            res["wrapper_ms"] = event_ms(lambda: kern(*prep_k, w, h), reps)
            if key in ("k1", "k2g", "k2d"):
                pairs = (int(prep_k[0].sum().item())
                         + tile_pairs(prep_k[4], w, h))
            elif key in ("k3", "k3g", "k3d", "k5", "k5g"):
                pairs = tile_pairs(prep_k[2], w, h)
            else:
                pairs = tile_pairs(rows_of[key][0], w, h)
            planes = (raster.GBUFFER_PLANES if key.endswith("g")
                      else 1 if key.endswith("d") else 2)
            evals = nbytes = None
            if key in ("k1", "k2d"):  # sub-tile blocks, vertex windows
                evals, nbytes = small_work(prep_k, w, h, planes)
            if key in resolve_names or key in hier_resolve_names:
                # the keyed body
                evals, nbytes = keyed_work(
                    prep_k, w, h, HEIGHT if h == PAD_H else h, planes,
                    None if key.endswith("d") else kern(*prep_k, w, h)[1],
                    WINNER_GBUF_BYTES if key.endswith("g") else WINNER_BYTES,
                    strict=key in ("k3", "k3g", "k5", "k5g"))
            set_bound(key, flat_inputs(prep_k), pairs, w, h, shape,
                      planes=planes, evals=evals, nbytes=nbytes)
            print(f"  {key} {shape} {w}x{h}: kernel {res['ms']:.4f} "
                  f"ms device time (profiler; {res['anim_ms']:.4f} ms a "
                  f"launch in the profiled render_animation), launcher "
                  f"{res['wrapper_ms']:.4f} ms/call (CUDA events); plain "
                  f"version {res['plain_ms']:.4f} ms/call at "
                  f"{res['plain_shape']} (CUDA events)")
        # The band kernels: bounds, launcher times, the per-band prepares
        # and the sharded frames' ms (bands in turn, CUDA events).
        for key, (prep_k, r0, bh, shape, pairs) in band_prep.items():
            kern = kernel_of[key]
            res = results[key]
            res["wrapper_ms"] = event_ms(
                lambda: kern(*prep_k, PAD_W, bh, r0), band_reps[key])
            if key == "k9d":  # records of every source's spans
                offs = prep_k[0]
                used = int((offs[:, -1] - offs[:, 0]).sum().item())
                inputs = [offs, *prep_k[3:7], prep_k[1][:used],
                          prep_k[2][:used]]
            else:
                inputs = flat_inputs(prep_k)
            evals = nbytes = None
            if key in ("k3b", "k9", "k9d"):  # the keyed body, the band
                evals, nbytes = keyed_work(
                    prep_k, PAD_W, bh, HEIGHT, 2,
                    kern(*prep_k, PAD_W, bh, r0)[1], WINNER_BYTES,
                    strict=key == "k3b", row0=r0)
            set_bound(key, inputs, pairs, PAD_W, bh, shape,
                      planes=raster.GBUFFER_PLANES if key == "k9g" else 2,
                      evals=evals, nbytes=nbytes)
            print(f"  {key} {shape} {PAD_W}x{bh} at row {r0}: kernel "
                  f"{res['ms']:.4f} ms device time (profiler; "
                  f"{res['anim_ms']:.4f} ms a launch in the profiled sharded"
                  f" frame), launcher {res['wrapper_ms']:.4f} ms/call (CUDA "
                  f"events); plain version {res['plain_ms']:.4f} ms/call at "
                  f"{res['plain_shape']} (CUDA events)")
        def registers(name):
            """ptxas's registers a thread of kernel ``name``."""
            return ptxas_entry(name, PTXAS_REGISTERS)

        # The small-scene kernels: K1 and K2d at the library's blocks a
        # tile, K2g one block a tile.
        small_blocks = _build.load_library().zr_small_blocks_per_tile()
        for key, blocks in (("k1", small_blocks), ("k2g", None),
                            ("k2d", small_blocks)):
            res = results[key]
            res["registers"] = ptxas_entry(kernel_names[key],
                                           PTXAS_REGISTERS, blocks)
            res["smem_bytes"] = ptxas_entry(kernel_names[key], PTXAS_SMEM,
                                            blocks)
            print(f"  {key} {kernel_names[key]}: {res['registers']} "
                  f"registers, {res['smem_bytes']} bytes of static shared "
                  f"memory a block; bound {res['bound_ms']:.4f} ms by "
                  f"{res['bound_by']} ({res.get('evals')} window pixel "
                  f"evaluations); kernel {res['ms']:.4f} ms a call")
        # K6's, K6g's and K6d's grids count every slot of pair_tri (n_head
        # * cap).
        for key in ("k6", "k6g", "k6d"):
            prep_k, shape, _ = cases[key]
            w, h = size_of.get(key, (PAD_W, PAD_H))
            spans = int((prep_k[0][-1] - prep_k[0][0]).item())
            slots = prep_k[1].shape[0]
            n_tiles = prep_k[0].shape[0] - 1
            size, items = keyed_table(prep_k[0], raster.ITEM_RECORDS,
                                      prep_k[2].shape[0], n_tiles)
            blocks = raster.keyed_items(w, h, slots, raster.ITEM_RECORDS, 0,
                                        raster.KEYED_MIN_ITEMS)
            bound = n_tiles + spans // size
            print(f"  {key} {shape} {w}x{h}: {spans} span entries of "
                  f"{slots} pair_tri slots, items of {size} records; "
                  f"{blocks} blocks launched, {blocks - bound} past the "
                  f"spans' bound (they return before the scan), "
                  f"{bound - items.shape[0]} more find no item, "
                  f"{items.shape[0]} items")
        for key in resolve_names:  # the keyed record kernels
            res = results[key]
            res["registers"] = registers(kernel_names[key])
            # Each prepare's spans index its output's tiles (K9's band).
            prep_k = cases[key][0] if key in cases else band_prep[key][0]
            coarse_k = prep_k[7] if len(prep_k) == 8 else None
            res["item_records"], items_k = keyed_table(
                prep_k[0], raster.ITEM_RECORDS,
                prep_k[2 if len(prep_k) == 6 else 3].shape[0],
                prep_k[0].shape[-1] - 1,
                *(() if coarse_k is None else (coarse_k[0],
                                               PAD_W // raster.TILE_W)))
            print(f"  {key} keyed body at its main-path shape: items of "
                  f"{res['item_records']} records, {items_k.shape[0]} items; "
                  f"{kernel_names[key]} "
                  f"{res['registers']} registers, "
                  f"{registers(resolve_names[key])} in "
                  f"{resolve_names[key]}; {res.get('smem_bytes')} bytes of "
                  f"dynamic shared memory an item; bound "
                  f"{res.get('bound_ms', float('nan')):.4f} ms by "
                  f"{res.get('bound_by')} ({res.get('evals')} window pixel "
                  f"evaluations, {res.get('bytes')} bytes); kernel "
                  f"{res.get('ms', float('nan')):.4f} ms a call")
        ti_k, tf_k, s_k = s_rows["k9"]
        print(f"  per-band prepare, lattice1M band 0 of 2 (band-local "
              f"prepare_binned_hbm_inputs): "
              f"{event_ms(lambda: band_prepare(ti_k, tf_k, s_k), 5):.4f} "
              "ms/call (CUDA events)")
        locals40, ti40, tf40, s40 = tiles.setups_in_turn(
            2, *indexed_args(r_lattice40, H2), PAD_W, H2)
        rec40 = dist_received(locals40, H2, 2, s40)[0]
        local_ms = event_ms(lambda: raster.prepare_binned_dist_local(
            *locals40[0], PAD_W, H2, 2, 0, s40), 5)
        owner_ms = event_ms(lambda: raster.prepare_binned_dist_owner(
            ti40, tf40, *rec40), 5)
        print(f"  per-band prepare, lattice40k dist: one shard's "
              f"prepare_binned_dist_local {local_ms:.4f} ms/call, the "
              f"owner's prepare_binned_dist_owner {owner_ms:.4f} ms/call "
              "(CUDA events)")
        for key, (label, fn) in band_frames.items():
            print(f"  sharded frame {WIDTH}x{H2} {label}, one card rendering "
                  f"every band in turn: {event_ms(fn, 3):.4f} ms/frame (CUDA "
                  "events, host dispatch included)")
        for key, name, inputs in light_runs:
            res = results[key]
            sfx = "" if name == "wide" else "_r2"
            wrapper = event_ms(lambda: light_of[key](*inputs), 20)
            pairs, evals, _ = light_work(inputs)
            mask = inputs[1]
            nbytes = (sum(t.numel() * t.element_size() for t in inputs)
                      + 3 * 4 * mask.numel())
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = evals * OPS_PER_LIGHT[key] / CUDA_CORE_OPS_PER_S * 1e3
            res.update({f"bound_ms{sfx}": max(t_bytes, t_ops),
                        f"bound_by{sfx}": ("bytes" if t_bytes >= t_ops
                                           else "operations"),
                        f"pairs{sfx}": pairs, f"evals{sfx}": evals,
                        f"wrapper_ms{sfx}": wrapper})
            res["shape"] = res["plain_shape"] = "test scene, wide lights"
            print(f"  {key} test scene, {name} lights {PAD_W}x{PAD_H}: "
                  f"kernel {res['ms' + sfx]:.4f} ms device time (profiler), "
                  f"launcher {wrapper:.4f} ms/call (CUDA events); plain "
                  f"version {res['plain_ms' + sfx]:.4f} ms/call (CUDA "
                  f"events); {pairs} light-tile pairs, {evals} evaluations "
                  f"x {OPS_PER_LIGHT[key]} ops -> {t_ops:.4f} ms; {nbytes} bytes "
                  f"-> {t_bytes:.4f} ms; bound {res['bound_ms' + sfx]:.4f} "
                  f"ms by {res['bound_by' + sfx]}")

        # K8 and K8b: bytes and operations of the --ui frame's inputs.
        ti8, tf8 = ov_rows
        hits = int((cnt8 + over8).sum().item())
        live = int(cnt8.sum().item())
        pairs = tile_pairs(ti8, WIDTH, HEIGHT)
        pix = WIDTH * HEIGHT
        planes8 = 2 + 3 * overlay.DEFAULT_K
        bound_inputs = {
            "k8": ((ti8.numel() + tf8.numel()) * 4 + planes8 * 4 * pix,
                   pairs * raster.TILE_H * raster.TILE_W
                   * OPS_PER_OVERLAY_EVAL + hits * OPS_PER_OVERLAY_HIT,
                   lambda: k8(*ov_rows, WIDTH, HEIGHT)),
            "k8b": ((4 + 4 + 4) * pix + 12 * live
                    + atlas_dev.numel() * 4,
                    live * OPS_PER_COMPOSITE_LAYER,
                    lambda: k8b(frame8, cnt8, lay8, atlas_dev)),
        }
        results["k8"].update(pairs=pairs, covered=hits)
        results["k8b"].update(live_layers=live)
        for key, (nbytes, ops, fn) in bound_inputs.items():
            res = results[key]
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
            res.update(bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       shape="--ui windows, test scene",
                       wrapper_ms=event_ms(fn, 20))
            print(f"  {key} --ui windows {WIDTH}x{HEIGHT}: kernel "
                  f"{res['ms']:.4f} ms device time (profiler; "
                  f"{res['anim_ms']:.4f} ms a launch in the profiled --ui "
                  f"frame), launcher {res['wrapper_ms']:.4f} ms/call (CUDA "
                  f"events); plain version {res['plain_ms']:.4f} ms/call "
                  f"(CUDA events); {pairs} (tile, triangle) pairs, {hits} "
                  f"covered (pixel, triangle), {live} live layers; {ops:.4e} "
                  f"ops -> {t_ops:.4f} ms; {nbytes} bytes -> {t_bytes:.4f} "
                  f"ms; bound {res['bound_ms']:.4f} ms by {res['bound_by']}")

    # -- 4xv. K10vis/K10trans vs plain ----------------------------------------
    def vt_check(key, label, rows, w, h, visible, plain_shape=None,
                 empty=False):
        """Kernel ``key`` against its plain version on ``rows``: depth
        bits and row ids equal; the colour resolved on the card equal to
        the same resolve on the CPU; rows [0, visible) of the frame equal
        to K5's (RGBA and depth bits).  Returns (color, depth, idx)."""
        kern, plain, _, prepare = vt_cases[key]
        *args, table = prepare(*rows, w, h)
        sync()
        dk, ik = kern(*args, w, h)
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dp, ip = plain(*args, w, h)
        end.record()
        sync()
        if plain_shape is not None:
            results[key]["plain_ms"] = start.elapsed_time(end)
            results[key]["plain_shape"] = plain_shape
        same = (torch.equal(dk.view(torch.int32), dp.view(torch.int32))
                and torch.equal(ik, ip))
        ids_off = int((ik != ip).sum().item())
        err = (dk - dp).abs().max().item()
        ck = vis_trans.resolve_flat_vis(dk, ik, table)
        same_c = torch.equal(ck.cpu(), vis_trans.resolve_flat_vis(
            dk.cpu(), ik.cpu(), table.cpu()))
        c5, d5 = k5(*raster.prepare_raster_inputs(*rows), w, h)
        vis = slice(0, visible)
        same5 = same_planes((ck[vis], dk[vis]), (c5[vis], d5[vis]))
        cov = (dk < 1.0).float().mean().item()
        print(f"  {label} ({key}, {w}x{h}): {args[2].shape[0]} rows, "
              f"bit-exact={same} (depth bits and ids; {ids_off} ids "
              f"differ, max_abs_err={err}), card resolve equal to the "
              f"CPU's {same_c}, rows 0-{visible - 1} equal K5's {same5}, "
              f"coverage={cov:.4f}", flush=True)
        if not (same and same_c):
            raise AssertionError(f"{label}: {key} and its plain version "
                                 "or the two resolves differ")
        if not same5:
            raise AssertionError(f"{label}: {key} differs from K5 in the "
                                 "visible rows")
        if (cov <= 0.0) != empty:
            raise AssertionError(f"{label}: coverage {cov}")
        results[key]["err"] = max(results[key]["err"], float(err))
        return ck, dk, ik

    @phase("4xv K10vis/K10trans experiment kernels vs plain versions")
    def vis_cases():
        rows40 = setup_rows(*make_stress_scene(MID_TRIS), WIDTH, HEIGHT,
                            tri_align=256)
        scene_rows = setup_rows(*load_test_scene(), WIDTH, HEIGHT)
        clipped = setup_rows(*clipped_soup(), WIDTH, HEIGHT)
        w, h = 1024, 512
        dup = setup_rows(*tie_soup(True), w, h)
        one = setup_rows(*tie_soup(False), w, h)
        # Geometry at 128x56, raster at 128x64: rows 56-63 are padding.
        padded = setup_rows(*make_triangle_soup(1500, seed=5, extent=6.0),
                            128, 56)
        c5, d5 = k5(*raster.prepare_raster_inputs(*padded), 128, 64)
        pad = slice(56, 64)
        print(f"  padded soup 128x64: K5 draws {int((d5[pad] < 1.0).sum())} "
              "pixels in rows 56-63")
        # A tall row A and a short row B inside it, B after A: an exact
        # tie at z == 0 with A's -0.0 and B's +0.0, then the other way; A
        # at z = e0 / 4, exactly 1.0 on one covered pixel.
        neg_first = pair_rows(za_a=(-0.0,) * 3, za_b=(0.0,) * 3)
        neg_second = pair_rows(za_a=(0.0,) * 3, za_b=(-0.0,) * 3)
        z_one = pair_rows(za_a=(0.25, 0.0, 0.0))
        t = tg.capped_rows(64)
        ti = torch.zeros((t + (-t) % 64, tg.NI32), dtype=torch.int32,
                         device=dev)
        ti[:, tg.I_JMIN] = 1
        ti[:, tg.I_BIAS0:tg.I_BIAS2 + 1] = 2**31 - 1
        empty = (ti, torch.zeros((ti.shape[0], tg.NF32), device=dev))
        drawn_in_pad = {"k10vis": 451, "k10trans": 0}
        saved = vis_trans.VIS_ITEMS
        try:
            # The main path's items, then one item a tile (resolved in
            # place): every case at both.
            for n in (saved, 1):
                vis_trans.VIS_ITEMS = n
                print(f"  -- {n} work item(s) a tile")
                for key in vt_cases:
                    t0 = time.perf_counter()
                    vt_check(key, "lattice40k", rows40, PAD_W, PAD_H,
                             HEIGHT, plain_shape="lattice40k" if n == saved
                             else None)
                    print(f"  (plain {key} included: "
                          f"{time.perf_counter() - t0:.1f} s)")
                for key in vt_cases:
                    vt_check(key, "test scene", scene_rows, PAD_W, PAD_H,
                             HEIGHT)
                    vt_check(key, "clipped soup", clipped, PAD_W, PAD_H,
                             HEIGHT)
                    c_dup, d_dup, _ = vt_check(key, "duplicated triangles",
                                               dup, w, h, h)
                    c_one, d_one, _ = vt_check(key, "duplicates removed",
                                               one, w, h, h)
                    if not same_planes((c_dup, d_dup), (c_one, d_one)):
                        raise AssertionError(f"{key}: a duplicate won a "
                                             "depth tie")
                    c, d, _ = vt_check(key, "padded soup", padded, 128, 64,
                                       56)
                    drawn = int((d[pad] < 1.0).sum().item())
                    other = int(((d[pad] != d5[pad]) | (c[pad] != c5[pad]))
                                .sum().item())
                    print(f"  padded soup ({key}): {drawn} pixels drawn in "
                          f"rows 56-63, {other} of them differ from K5's")
                    if drawn != drawn_in_pad[key]:
                        raise AssertionError(
                            f"padded soup: {key} drew {drawn} pixels in "
                            f"rows 56-63, not {drawn_in_pad[key]}")
                    for label, rows, sign in (("-0.0 then +0.0", neg_first,
                                               True),
                                              ("+0.0 then -0.0", neg_second,
                                               False)):
                        _, d, i = vt_check(key, f"exact tie at z == 0, "
                                           f"{label}", rows, 128, 32, 32)
                        zero = d == 0.0
                        ids = torch.unique(i[zero]).tolist()
                        neg = bool((torch.signbit(d[zero]) == sign).all()
                                   .item())
                        print(f"  tie at z == 0, {label} ({key}): "
                              f"{int(zero.sum().item())} pixels, ids "
                              f"{ids}, the first row's sign kept {neg}")
                        if ids != [0] or not neg:
                            raise AssertionError(f"{key}: the tie at z == "
                                                 "0 went to the second row")
                    _, d, i = vt_check(key, "z == 1.0", z_one, 128, 32, 32)
                    if bool(((d == 1.0) & (i >= 0)).any().item()):
                        raise AssertionError(f"{key}: a row at z == 1.0 "
                                             "passed")
                    c, d, i = vt_check(key, "empty scene", empty, PAD_W,
                                       PAD_H, PAD_H, empty=True)
                    if not (bool((i == -1).all().item())
                            and bool((c == -(1 << 24)).all().item())):
                        raise AssertionError(f"empty scene: {key} drew "
                                             "something")
        finally:
            vis_trans.VIS_ITEMS = saved
        print("  every exact depth tie went to the first-submitted row "
              f"(K10vis, K10trans; {saved} and 1 work item(s) a tile)")

    # -- 5xv. the visibility-buffer frames at 1M ------------------------------
    @phase("5xv K10vis/K10trans frames at 1M")
    def vis_frames():
        """Each entry point once on the 1M lattice at 1920x1088, with every
        launch count set to 0 just before and read just after; rows
        0-1079 against K5's frame, the pixels drawn in rows 1080-1087.
        Then each kernel against its plain version on one 1M prepare, all
        1088 rows, where the plain version's 40K time scaled to 1M rows
        stays under PLAIN_1M_MAX_S."""
        ti, tf = rows_1m
        c5, d5 = k5(*raster.prepare_raster_inputs(ti, tf), PAD_W, PAD_H)
        vis, pad = slice(0, HEIGHT), slice(HEIGHT, PAD_H)
        drawn_in_pad = {"k10vis": 2610, "k10trans": 745}
        for key, (_, _, fn, _) in vt_cases.items():
            sync()
            for kern in kernel_of.values():
                kern.launches = 0
            c, d = fn(ti, tf, PAD_W, PAD_H)
            sync()
            launched = {k: kern.launches for k, kern in kernel_of.items()
                        if kern.launches}
            if launched != {key: 1}:
                raise AssertionError(f"{key}: launches {launched}, one "
                                     f"{key} launch expected")
            counts[key] = 1
            same5 = same_planes((c[vis], d[vis]), (c5[vis], d5[vis]))
            cov = (d[vis] < 1.0).float().mean().item()
            drawn = int((d[pad] < 1.0).sum().item())
            results[key]["pad_pixels_1m"] = drawn
            print(f"  lattice1M {PAD_W}x{PAD_H} ({key}, one launch): rows "
                  f"0-{HEIGHT - 1} equal K5's {same5} (RGBA and depth bits),"
                  f" coverage {cov:.4f}; rows {HEIGHT}-{PAD_H - 1}: "
                  f"{drawn} pixels drawn, K5 "
                  f"{int((d5[pad] < 1.0).sum().item())}")
            if not same5 or cov <= MIN_COVERAGE:
                raise AssertionError(f"lattice1M: {key} differs from K5 in "
                                     "the visible rows")
            if drawn != drawn_in_pad[key]:
                raise AssertionError(f"lattice1M: {key} drew {drawn} "
                                     f"pixels in rows {HEIGHT}-{PAD_H - 1}, "
                                     f"not {drawn_in_pad[key]}")
        vt_preps = vis_inputs_1m()[0]
        for key, (kern, plain, _, _) in vt_cases.items():
            *args, _ = vt_preps[key]
            plain_ms = results[key].get("plain_ms")
            predicted = (None if plain_ms is None
                         else plain_ms / 1e3 * ti.shape[0] / MID_TRIS)
            if predicted is not None and predicted > PLAIN_1M_MAX_S:
                print(f"  lattice1M ({key}): plain version not run, its "
                      f"40K time scaled by the rows predicts {predicted:.1f}"
                      f" s > {PLAIN_1M_MAX_S:.0f} s; held at 40K only")
                continue
            out = kern(*args, PAD_W, PAD_H)
            sync()
            t0 = time.perf_counter()
            ref = plain(*args, PAD_W, PAD_H)
            sync()
            secs = time.perf_counter() - t0
            results[key]["plain_s_1m"] = secs
            same = same_planes(out, ref)
            print(f"  lattice1M {PAD_W}x{PAD_H} ({key}): kernel and plain "
                  f"version bit-exact in all {PAD_H} rows {same} (depth "
                  f"bits and ids; plain version {secs:.1f} s, predicted "
                  f"{predicted} s)", flush=True)
            if not same:
                raise AssertionError(f"lattice1M: {key} and its plain "
                                     "version differ")
        print(f"  launches in one main-path frame: "
              f"{ {k: counts[k] for k in vt_cases} }")

    # -- 6xv (untraced). launcher, resolve and prepare times; bounds ----------
    def vis_work(key, args, w, h):
        """The work kernel ``key``'s keyed body needs on ``args``: (admitted
        (tile, row) pairs, their window pixel evaluations, bytes needed).
        A pair's window is its row's vertices' pixel bbox in the tile
        within the kernel's extent (``vis_trans.window_rects``: K10vis the
        tile, K10trans its group's chunk rows): inside the geometry's rows
        it holds every pixel the row covers, in the padding rows the
        kernel's own extent.  The bytes: the tables (K10vis the superblocks
        and the bitmap, K10trans the superblocks, blocks and group bounds),
        each admitted row's 20 setup ints and 3 z floats once and the two
        planes; the store reads no row."""
        if key == "k10vis":
            supers, bits, ti, _ = args
            hits = vis_trans.vis_block_hits(supers, bits, ti.shape[0], w, h)
            rows, ty, tx = vis_trans.admitted_rows(hits, w, bits=bits)
            rect = vis_trans.window_rects(ti, rows, ty, tx)
            tables = (supers, bits)
        else:
            supers, blocks, rec, gbounds = args
            hits = raster.hier_block_hits(supers, blocks, w, h)
            rows, ty, tx = vis_trans.admitted_rows(hits, w, gbounds=gbounds)
            rect = vis_trans.window_rects(rec, rows, ty, tx,
                                          gbounds=gbounds)
            tables = (supers, blocks, gbounds)
        evals = int(((rect[:, 1] - rect[:, 0] + 1).clamp(min=0)
                     * (rect[:, 3] - rect[:, 2] + 1).clamp(min=0))
                    .sum().item())
        nbytes = (sum(t.numel() * t.element_size() for t in tables)
                  + torch.unique(rows).numel() * (tg.NI32 * 4 + 12)
                  + 2 * 4 * w * h)
        return rows.numel(), evals, nbytes

    @phase("6xv K10vis/K10trans untraced times and bounds")
    def vis_timing():
        """The launchers, the resolve and the prepares between CUDA
        events at 1M, and the bounds: the window pixel evaluations each
        kernel needs (``vis_work``) x OPS_PER_EVAL, or the bytes its keyed
        body needs (every input read once and the two planes kept as
        bound_ms_inputs, and the (4x128 chunk, triangle) pairs x 512 x
        OPS_PER_VIS_PAIR as bound_ms_chunks, the register body's bound);
        the resolve by its bytes; ptxas's registers, spills and shared
        memory of each kernel's item, resolve and hit-word kernels."""
        ti, tf = rows_1m
        w, h = PAD_W, PAD_H
        vt_preps, (depth, idx, table), resolve_busy = vis_inputs_1m()
        res_ms = event_ms(
            lambda: vis_trans.resolve_flat_vis(depth, idx, table), 20)
        covered = int((idx >= 0).sum().item())
        nbytes = 3 * 4 * w * h + VIS_TABLE_BYTES * covered
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        for key in vt_cases:
            results[key].update(resolve_ms=res_ms,
                                resolve_busy_ms=resolve_busy,
                                resolve_bound_ms=bound)
        print(f"  resolve_flat_vis on lattice1M {w}x{h}: device busy "
              f"{resolve_busy} ms (6xv's trace); {res_ms:.4f} ms/call "
              f"(CUDA events, host dispatch included); bound {bound:.4f} ms "
              f"by bytes ({nbytes} bytes: depth, id and colour planes, "
              f"{covered} table rows)")
        chunk_pairs = tile_pairs(ti, w, h, 4, raster.TILE_W)
        for key, (kern, _, _, prepare) in vt_cases.items():
            *args, _ = vt_preps[key]
            res = results[key]
            res["wrapper_ms"] = event_ms(lambda: kern(*args, w, h), 5)
            res["prepare_ms"] = event_ms(lambda: prepare(ti, tf, w, h), 5)
            pairs, evals, nbytes = vis_work(key, args, w, h)
            all_bytes = (sum(t.numel() * t.element_size() for t in args)
                         + 2 * 4 * w * h)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_all = all_bytes / HBM_BYTES_PER_S * 1e3
            t_ops = evals * OPS_PER_EVAL / CUDA_CORE_OPS_PER_S * 1e3
            t_chunks = (chunk_pairs * 4 * raster.TILE_W * OPS_PER_VIS_PAIR
                        / CUDA_CORE_OPS_PER_S * 1e3)
            res.update(pairs=pairs, evals=evals, bytes=nbytes,
                       bound_ms=max(t_bytes, t_ops),
                       bound_ms_inputs=max(t_all, t_ops),
                       bound_ms_chunks=max(t_all, t_chunks),
                       shape="lattice1M",
                       bound_by="bytes" if t_bytes >= t_ops
                       else "operations")
            names = (kernel_names[key], vis_resolve_names[key],
                     hit_words_names[key])
            res["registers"] = ptxas_entry(names[0], PTXAS_REGISTERS)
            print(f"  {key} ptxas: " + "; ".join(
                f"{n} {ptxas_entry(n, PTXAS_REGISTERS)} registers, "
                f"{ptxas_entry(n, PTXAS_SPILLS)} bytes spilled, "
                f"{ptxas_entry(n, PTXAS_SMEM)} bytes of static shared "
                "memory" for n in names)
                  + f"; {res.get('smem_bytes')} bytes of dynamic shared "
                  "memory an item")
            print(f"  {key} lattice1M {w}x{h}: {pairs} admitted (tile, "
                  f"row) pairs, {evals} window pixel evaluations -> "
                  f"{t_ops:.4f} "
                  f"ms; {nbytes} bytes needed -> {t_bytes:.4f} ms (every "
                  f"input once {all_bytes} bytes, {t_all:.4f} ms); bound "
                  f"{res['bound_ms']:.4f} ms by {res['bound_by']} "
                  f"({chunk_pairs} 4x128 chunk pairs x 512 x "
                  f"{OPS_PER_VIS_PAIR}: "
                  f"{res['bound_ms_chunks']:.4f} ms); kernel "
                  f"{res.get('ms')} ms device time (profiler; "
                  f"{res.get('anim_ms')} ms in the traced entry point), "
                  f"launcher {res['wrapper_ms']:.4f} ms/call (CUDA events); "
                  f"plain version {res.get('plain_ms')} ms/call at "
                  f"{res.get('plain_shape')} (CUDA events); prepare "
                  f"{res['prepare_ms']:.4f} ms/call (CUDA events, host "
                  "dispatch included)")

    # -- 4h. K10hbm2/K10scan vs plain --------------------------------------
    def vs_k5(key, c, d, c5, d5, visible):
        """Rows [0, visible) of kernel ``key``'s (c, d) against K5's (c5,
        d5), RGBA and depth bits.  Returns (equal but for the kernel's
        rules, pixels latched at z == 1.0 that K5 leaves clear, pixels
        whose -0.0 depth is +0.0 here).  Both kernels may latch z == 1.0;
        only K10scan may store -0.0 as +0.0, K10hbm2 keeps it."""
        vis = slice(0, visible)
        c, d, c5, d5 = c[vis], d[vis], c5[vis], d5[vis]
        diff = (c != c5) | (d.view(torch.int32) != d5.view(torch.int32))
        z1 = diff & (d == 1.0) & (d5 == 1.0)
        neg = (diff & (c == c5) & (d5 == 0.0) & torch.signbit(d5)
               & ~torch.signbit(d))
        allowed = z1 | neg if key == "k10scan" else z1
        return (not bool((diff & ~allowed).any().item()),
                int(z1.sum().item()), int(neg.sum().item()))

    def th_check(key, label, rows, w, h, visible, plain_shape=None,
                 empty=False):
        """Kernel ``key`` against its plain version on ``rows``: packed
        colour and depth bits equal in every row; rows [0, visible)
        against K5's frame (``vs_k5``).  Returns (color, depth, K5's color
        and depth, the z == 1.0 pixels)."""
        kern, plain, _, prepare = th_cases[key]
        args = prepare(*rows, h)
        sync()
        ck, dk = kern(*args, w, h)
        sync()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        cp, dp = plain(*args, w, h)
        end.record()
        sync()
        if plain_shape is not None:
            results[key]["plain_ms"] = start.elapsed_time(end)
            results[key]["plain_shape"] = plain_shape
        same = (torch.equal(ck, cp)
                and torch.equal(dk.view(torch.int32), dp.view(torch.int32)))
        err = max(
            (raster.unpack_rgba8(ck).int() - raster.unpack_rgba8(cp).int())
            .abs().max().item(), (dk - dp).abs().max().item())
        c5, d5 = k5(*raster.prepare_raster_inputs(*rows), w, h)
        same5, z1, neg = vs_k5(key, ck, dk, c5, d5, visible)
        cov = (dk < 1.0).float().mean().item()
        print(f"  {label} ({key}, {w}x{h}): {args[2].shape[0]} rows, "
              f"bit-exact={same} (colour and depth bits, all {h} rows; "
              f"max_abs_err={err}), rows 0-{visible - 1} equal K5's "
              f"{same5} (z == 1.0 latched on {z1} pixels, -0.0 stored "
              f"+0.0 on {neg}), coverage={cov:.4f}", flush=True)
        if not same:
            raise AssertionError(f"{label}: {key} and its plain version "
                                 "differ")
        if not same5:
            raise AssertionError(f"{label}: {key} differs from K5 in the "
                                 "visible rows")
        if (cov <= 0.0) != empty:
            raise AssertionError(f"{label}: coverage {cov}")
        results[key]["err"] = max(results[key]["err"], float(err))
        return ck, dk, c5, d5, z1

    @phase("4h K10hbm2/K10scan experiment kernels vs plain versions")
    def twoclass_cases():
        rows40 = setup_rows(*make_stress_scene(MID_TRIS), WIDTH, HEIGHT,
                            tri_align=256)
        for key in th_cases:
            t0 = time.perf_counter()
            th_check(key, "lattice40k", rows40, PAD_W, PAD_H, HEIGHT,
                     plain_shape="lattice40k")
            print(f"  (plain {key} included: "
                  f"{time.perf_counter() - t0:.1f} s)")
        scene_rows = setup_rows(*load_test_scene(), WIDTH, HEIGHT)
        clipped = setup_rows(*clipped_soup(), WIDTH, HEIGHT)
        w, h = 1024, 512
        dup = setup_rows(*tie_soup(True), w, h)
        one = setup_rows(*tie_soup(False), w, h)
        stress = setup_rows(*make_stress_scene(1536), 256, 64)
        # Geometry at 128x56, raster at 128x64: rows 56-63 are padding.
        padded = setup_rows(*make_triangle_soup(1500, seed=5, extent=6.0),
                            128, 56)
        tie = pair_rows(za_a=(0.0, 0.0, 0.0), za_b=(0.0, 0.0, 0.0))
        z_one = pair_rows(za_a=(0.25, 0.0, 0.0))
        neg_zero = pair_rows(za_b=(-0.0, -0.0, -0.0))
        t = tg.capped_rows(64)
        ti = torch.zeros((t + (-t) % 64, tg.NI32), dtype=torch.int32,
                         device=dev)
        ti[:, tg.I_JMIN] = 1
        ti[:, tg.I_BIAS0:tg.I_BIAS2 + 1] = 2**31 - 1
        empty = (ti, torch.zeros((ti.shape[0], tg.NF32), device=dev))
        short = raster.classify_short(stress[0])
        live = stress[0][:, tg.I_VALID] > 0
        print(f"  stress mix 256x64: {int(live.sum().item())} live rows, "
              f"{int(short.sum().item())} short")
        pad = slice(56, 64)
        for key in th_cases:
            th_check(key, "test scene", scene_rows, PAD_W, PAD_H, HEIGHT)
            th_check(key, "clipped soup", clipped, PAD_W, PAD_H, HEIGHT)
            c_dup, d_dup, *_ = th_check(key, "duplicated triangles", dup, w,
                                        h, h)
            c_one, d_one, *_ = th_check(key, "duplicates removed", one, w,
                                        h, h)
            if not same_planes((c_dup, d_dup), (c_one, d_one)):
                raise AssertionError(f"{key}: a duplicate won a depth tie")
            th_check(key, "stress mix", stress, 256, 64, 64)
            c, d, c5, d5, _ = th_check(key, "padded soup", padded, 128, 64,
                                       56)
            drawn = int((d[pad] < 1.0).sum().item())
            other = int(((d[pad] != d5[pad]) | (c[pad] != c5[pad])).sum()
                        .item())
            print(f"  padded soup ({key}): rows 56-63: {drawn} pixels drawn,"
                  f" {other} differ from K5's, K5 "
                  f"{int((d5[pad] < 1.0).sum().item())}")
            if drawn != {"k10hbm2": 246, "k10scan": 36}[key]:
                raise AssertionError(f"padded soup: {key} drew {drawn} "
                                     "pixels in rows 56-63")
            c, d, _, _, _ = th_check(key, "cross-class exact tie", tie, 128,
                                     32, 32)
            red = -(1 << 24) | 255
            if not bool((c[d == 0.0] == red).all().item()):
                raise AssertionError(f"{key}: the short row won a tie")
            *_, z1 = th_check(key, "z == 1.0", z_one, 128, 32, 32)
            if z1 != 1:
                raise AssertionError(f"{key}: {z1} pixels latched at z == "
                                     "1.0, 1 expected")
            # The short row's z is -0.0: K5 and K10hbm2 store it, K10scan
            # stores +0.0.
            c, d, c5, d5, _ = th_check(key, "short row at z == -0.0",
                                       neg_zero, 128, 32, 32)
            neg = int((torch.signbit(d) & (d == 0.0)).sum().item())
            neg5 = int((torch.signbit(d5) & (d5 == 0.0)).sum().item())
            if neg5 == 0 or neg != (neg5 if key == "k10hbm2" else 0):
                raise AssertionError(f"{key}: {neg} pixels at -0.0, K5 "
                                     f"{neg5}")
            c, d, *_ = th_check(key, "empty scene", empty, PAD_W, PAD_H,
                                PAD_H, empty=True)
            if not bool((c == -(1 << 24)).all().item()):
                raise AssertionError(f"empty scene: {key} drew something")
        # One work item a tile (resolved in place) and 64 (a tile's rows
        # spread thin, ties split across items).
        saved = hbm2.TWOCLASS_ITEMS
        try:
            for n in (1, 64):
                hbm2.TWOCLASS_ITEMS = n
                for key in th_cases:
                    th_check(key, f"stress mix, {n} item(s) a tile", stress,
                             256, 64, 64)
                    th_check(key, f"duplicated triangles, {n} item(s) a "
                             "tile", dup, w, h, h)
                    th_check(key, f"lattice40k, {n} item(s) a tile", rows40,
                             PAD_W, PAD_H, HEIGHT)
        finally:
            hbm2.TWOCLASS_ITEMS = saved
        print("  every exact depth tie went to the first-submitted row "
              "(K10hbm2, K10scan)")

    # -- 5h. the two-class frames at 1M ---------------------------------------
    @phase("5h K10hbm2/K10scan frames at 1M")
    def twoclass_frames():
        """Each entry point once on the 1M lattice at 1920x1088, with every
        launch count set to 0 just before and read just after; rows
        0-1079 against K5's frame.  Then each kernel against its plain
        version on one 1M prepare, all 1088 rows, where the plain
        version's 40K time scaled to 1M rows stays under PLAIN_1M_MAX_S."""
        ti, tf = rows_1m
        c5, d5 = k5(*raster.prepare_raster_inputs(ti, tf), PAD_W, PAD_H)
        pad = slice(HEIGHT, PAD_H)
        live = ti[:, tg.I_VALID] > 0
        n_short = int(raster.classify_short(ti).sum().item())
        n_live = int(live.sum().item())
        print(f"  lattice1M: {ti.shape[0]} rows, {n_live} live, {n_short} "
              f"short ({n_short / n_live:.4f} of the live rows)")
        for key, (_, _, fn, _) in th_cases.items():
            results[key]["short_share"] = n_short / n_live
            sync()
            for kern in kernel_of.values():
                kern.launches = 0
            c, d = fn(ti, tf, PAD_W, PAD_H)
            sync()
            launched = {k: kern.launches for k, kern in kernel_of.items()
                        if kern.launches}
            if launched != {key: 1}:
                raise AssertionError(f"{key}: launches {launched}, one "
                                     f"{key} launch expected")
            counts[key] = 1
            same5, z1, neg = vs_k5(key, c, d, c5, d5, HEIGHT)
            cov = (d[:HEIGHT] < 1.0).float().mean().item()
            drawn = int((d[pad] < 1.0).sum().item())
            results[key].update(z_one_pixels_1m=z1, pad_pixels_1m=drawn)
            print(f"  lattice1M {PAD_W}x{PAD_H} ({key}, one launch): rows "
                  f"0-{HEIGHT - 1} equal K5's {same5} (RGBA and depth bits; "
                  f"z == 1.0 latched on {z1} pixels, -0.0 stored +0.0 on "
                  f"{neg}), coverage {cov:.4f}; rows {HEIGHT}-{PAD_H - 1}: "
                  f"{drawn} pixels drawn, K5 "
                  f"{int((d5[pad] < 1.0).sum().item())}")
            # The lattice has no pixel at z == 1.0 and no depth of -0.0,
            # so neither of the kernels' departures from K5 may show.
            if not same5 or z1 or neg or cov <= MIN_COVERAGE:
                raise AssertionError(f"lattice1M: {key} differs from K5 in "
                                     f"the visible rows ({z1} pixels at z "
                                     f"== 1.0, {neg} -0.0 stored +0.0)")
        for key, (kern, plain, _, _) in th_cases.items():
            args = th_preps[key]
            plain_ms = results[key].get("plain_ms")
            predicted = (None if plain_ms is None
                         else plain_ms / 1e3 * ti.shape[0] / MID_TRIS)
            if predicted is not None and predicted > PLAIN_1M_MAX_S:
                print(f"  lattice1M ({key}): plain version not run, its "
                      f"40K time scaled by the rows predicts {predicted:.1f}"
                      f" s > {PLAIN_1M_MAX_S:.0f} s; held at 40K only")
                continue
            out = kern(*args, PAD_W, PAD_H)
            sync()
            t0 = time.perf_counter()
            ref = plain(*args, PAD_W, PAD_H)
            sync()
            secs = time.perf_counter() - t0
            results[key]["plain_s_1m"] = secs
            same = same_planes(out, ref)
            print(f"  lattice1M {PAD_W}x{PAD_H} ({key}): kernel and plain "
                  f"version bit-exact in all {PAD_H} rows {same} (colour "
                  f"and depth bits; plain version {secs:.1f} s, predicted "
                  f"{predicted} s)", flush=True)
            if not same:
                raise AssertionError(f"lattice1M: {key} and its plain "
                                     "version differ")
        print(f"  launches in one main-path frame: "
              f"{ {k: counts[k] for k in th_cases} }")

    # -- 6h (untraced). launcher and prepare times; bounds --------------------
    def twoclass_work(key, args, w, h):
        """The work kernel ``key``'s keyed body needs on ``args``: (tall
        (tile, row) pairs, short pairs, the tall pairs' window pixel
        evaluations, the short pairs', bytes needed, distinct winning
        rows).  A pair's window is its row's vertices' pixel bbox in the
        tile within the kernel's extent (``hbm2.window_rects``: the tile
        for a tall row, the 8 tile rows of a K10hbm2 short row), a K10scan
        record's rectangle in the tile (inside its bbox): inside the
        geometry's rows it holds every pixel the row covers, in the
        padding rows the kernel's own extent.  The bytes: the four tables,
        each admitted row's NI32 ints and 3 z floats once (a K10scan
        record's lanes up to its id and 3 z floats), each distinct winning
        row's WINNER_BYTES (the plain version's key plane) and the two
        planes."""
        supers_s, blocks_s, short_rows, supers_t, blocks_t, ti_t, _ = args
        box = [tg.I_JMIN, tg.I_JMAX, tg.I_IMIN, tg.I_IMAX]

        def area(rect):
            return int(((rect[:, 1] - rect[:, 0] + 1).clamp(min=0)
                        * (rect[:, 3] - rect[:, 2] + 1).clamp(min=0))
                       .sum().item())

        rows_t, ty, tx = hbm2.rect_pairs(ti_t[:, box], blocks_t, supers_t, w,
                                         h)
        tall_evals = area(hbm2.window_rects(ti_t, rows_t, ty, tx, False))
        row_bytes = tg.NI32 * 4 + 12
        if key == "k10hbm2":
            rows_s, ty, tx = hbm2.rect_pairs(short_rows[:, box], blocks_s,
                                             supers_s, w, h)
            short_evals = area(hbm2.window_rects(short_rows, rows_s, ty, tx,
                                                 True))
            short_bytes = torch.unique(rows_s).numel() * row_bytes
            keys = hbm2.hbm2_keys(*args, w, h)
        else:
            rect = scanline.record_rects(blocks_s, short_rows)
            rows_s, ty, tx = hbm2.rect_pairs(rect, blocks_s, supers_s, w, h)
            r0, c0 = ty * raster.TILE_H, tx * raster.TILE_W
            r = rect[rows_s]
            short_evals = area(torch.stack([
                torch.maximum(r[:, 0], c0),
                torch.minimum(r[:, 1], c0 + raster.TILE_W - 1),
                torch.maximum(r[:, 2], r0),
                torch.minimum(r[:, 3], r0 + raster.TILE_H - 1)], 1))
            short_bytes = (torch.unique(rows_s).numel()
                           * ((scanline.WL_IDF + 1) * 4 + 12))
            keys = scanline.scanline_keys(*args, w, h)
        won = keys != hbm2.KEY_CLEAR
        winners = int(torch.unique(keys[won] & 0xFFFFFFFF).numel())
        nbytes = (sum(t.numel() * t.element_size()
                      for t in (supers_s, blocks_s, supers_t, blocks_t))
                  + torch.unique(rows_t).numel() * row_bytes + short_bytes
                  + winners * WINNER_BYTES + 2 * 4 * w * h)
        return (rows_t.numel(), rows_s.numel(), tall_evals, short_evals,
                nbytes, winners)

    @phase("6h K10hbm2/K10scan untraced times and bounds")
    def twoclass_timing():
        """The launchers and the prepares between CUDA events at 1M, and
        the bounds: the window pixel evaluations each kernel needs
        (``twoclass_work``) x OPS_PER_EVAL, or the bytes its keyed body
        needs (every input read once and the two planes kept as
        bound_ms_inputs); ptxas's registers, spills and shared memory of
        its three kernels."""
        ti, tf = rows_1m
        w, h = PAD_W, PAD_H
        for key, (kern, _, _, prepare) in th_cases.items():
            args = th_preps[key]
            res = results[key]
            res["wrapper_ms"] = event_ms(lambda: kern(*args, w, h), 5)
            res["prepare_ms"] = event_ms(lambda: prepare(ti, tf, h), 5)
            tall, short, tall_evals, short_evals, nbytes, winners = (
                twoclass_work(key, args, w, h))
            evals = tall_evals + short_evals
            all_bytes = (sum(t.numel() * t.element_size() for t in args)
                         + 2 * 4 * w * h)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_all = all_bytes / HBM_BYTES_PER_S * 1e3
            t_ops = evals * OPS_PER_EVAL / CUDA_CORE_OPS_PER_S * 1e3
            res.update(tall_pairs=tall, short_pairs=short,
                       tall_evals=tall_evals, short_evals=short_evals,
                       evals=evals, bytes=nbytes,
                       bound_ms_inputs=max(t_all, t_ops),
                       bound_ms=max(t_bytes, t_ops), shape="lattice1M",
                       bound_by="bytes" if t_bytes >= t_ops
                       else "operations")
            names = (kernel_names[key], twoclass_resolve_names[key],
                     TWOCLASS_HIT_WORDS_KERNEL)
            res["registers"] = ptxas_entry(names[0], PTXAS_REGISTERS)
            print(f"  {key} ptxas: " + "; ".join(
                f"{n} {ptxas_entry(n, PTXAS_REGISTERS)} registers, "
                f"{ptxas_entry(n, PTXAS_SPILLS)} bytes spilled, "
                f"{ptxas_entry(n, PTXAS_SMEM)} bytes of static shared "
                "memory" for n in names)
                  + f"; {res.get('smem_bytes')} bytes of dynamic shared "
                  "memory an item")
            print(f"  {key} lattice1M {w}x{h}: {tall} tall (tile, row) "
                  f"pairs, {short} short; window pixel evaluations: "
                  f"{tall_evals} tall, {short_evals} short, {evals} in all "
                  f"-> {t_ops:.4f} ms; {nbytes} bytes needed ({winners} "
                  f"winning rows) -> {t_bytes:.4f} ms (every input once "
                  f"{all_bytes} bytes, {t_all:.4f} ms); "
                  f"bound {res['bound_ms']:.4f} ms by {res['bound_by']}; "
                  f"kernel {res['ms']:.4f} ms device time (profiler; "
                  f"{res['anim_ms']:.4f} ms in the traced entry point), "
                  f"launcher {res['wrapper_ms']:.4f} ms/call (CUDA events);"
                  f" plain version {res.get('plain_ms')} ms/call at "
                  f"{res.get('plain_shape')} (CUDA events); prepare "
                  f"{res['prepare_ms']:.4f} ms/call (CUDA events, host "
                  "dispatch included)")
        # Where the time goes: each kernel with one view's superblocks
        # emptied (the other pass alone), and K5 over the same padded rows
        # uncompacted beside its own compacted ones.
        def emptied(supers):
            out = supers.clone()
            out[:, 0], out[:, 1] = 1, 0
            return out

        for key, (kern, _, _, _) in th_cases.items():
            sup_s, blk_s, rec_s, sup_t, blk_t, ti_t, tf_t = th_preps[key]
            e_s, e_t = emptied(sup_s), emptied(sup_t)
            short_ms = event_ms(lambda: kern(sup_s, blk_s, rec_s, e_t, blk_t,
                                             ti_t, tf_t, w, h), 5)
            tall_ms = event_ms(lambda: kern(e_s, blk_s, rec_s, sup_t, blk_t,
                                            ti_t, tf_t, w, h), 5)
            results[key].update(short_pass_ms=short_ms, tall_pass_ms=tall_ms)
            print(f"  {key} lattice1M: short pass alone {short_ms:.4f} "
                  f"ms/call, tall pass alone {tall_ms:.4f} ms/call (CUDA "
                  "events)")
        ti_p, tf_p = raster._pad_rows(ti, tf)
        blk_p, sup_p = tg.super_bounds(tg.block_bounds(ti_p))
        compacted = raster.prepare_raster_inputs(ti, tf)
        k5_ms = event_ms(lambda: k5(*compacted, w, h), 5)
        k5_unc = event_ms(lambda: k5(sup_p, blk_p, ti_p, tf_p, w, h), 5)
        for key in th_cases:
            results[key].update(k5_ms=k5_ms, k5_uncompacted_ms=k5_unc)
        print(f"  K5 on lattice1M's {ti_p.shape[0]} padded rows: live rows "
              f"compacted to the front {k5_ms:.4f} ms/call, uncompacted "
              f"{k5_unc:.4f} ms/call (CUDA events)")

    # -- 7. app -----------------------------------------------------------
    @phase("7 app")
    def app():
        ui_flags = {"--overlay", "--ui"}
        frames = {}
        for scene_dir, pipeline, extra in ((SCENE_DIR, "flat", []),
                                           (SHOWCASE_DIR, "lit", []),
                                           (SCENE_DIR, "shadowed", []),
                                           (SCENE_DIR, "deferred", []),
                                           (SCENE_DIR, "deferred", ["--taa"]),
                                           (SCENE_DIR, "flat", ["--overlay"]),
                                           (SCENE_DIR, "flat", ["--orbit"]),
                                           (SCENE_DIR, "flat",
                                            ["--ui", "--orbit"]),
                                           (SHOWCASE_DIR, "lit", ["--ui"])):
            with tempfile.TemporaryDirectory() as tmp:
                rc = app_main(["--scene", scene_dir, "--width", str(WIDTH),
                               "--height", str(HEIGHT), "--frames", "2",
                               "--out", tmp, "--device", DEVICE,
                               "--pipeline", pipeline, *extra])
                img = read_png(os.path.join(tmp, "frame_0001.png"))
                first = read_png(os.path.join(tmp, "frame_0000.png"))
            frames[scene_dir, pipeline, tuple(extra)] = img
            cov = (img[..., :3].astype(np.int32).sum(-1) > 0).mean()
            moved = bool((img != first).any())
            # The same run without the UI flag: the pixels the UI covers.
            base = frames.get((scene_dir, pipeline, tuple(
                f for f in extra if f not in ui_flags)))
            ui_share = (float((img != base).any(-1).mean())
                        if ui_flags & set(extra) else 0.0)
            print(f"  app {os.path.basename(scene_dir)} {pipeline} "
                  f"{' '.join(extra)}: rc={rc}, frame_0001.png {img.shape} "
                  f"coverage={cov:.4f}, frames 0 and 1 differ {moved}, UI "
                  f"pixels {ui_share:.4f}")
            if (rc != 0 or img.shape[:2] != (HEIGHT, WIDTH)
                    or cov <= MIN_COVERAGE):
                raise AssertionError("app frame missing or empty")
            if ui_flags & set(extra) and ui_share <= 0.001:
                raise AssertionError("app frame lacks the UI")
            if "--orbit" in extra and not moved:
                raise AssertionError("--orbit did not move the camera")

        # --ssaa 2 (the --debug --trace run is phase 7t).
        with tempfile.TemporaryDirectory() as tmp:
            rc = app_main(["--scene", SCENE_DIR, "--width", str(WIDTH),
                           "--height", str(HEIGHT), "--frames", "2",
                           "--out", tmp, "--device", DEVICE, "--ssaa", "2"])
            img = read_png(os.path.join(tmp, "frame_0001.png"))
        cov = (img[..., :3].astype(np.int32).sum(-1) > 0).mean()
        print(f"  app test scene flat --ssaa 2: rc={rc}, frame_0001.png "
              f"{img.shape} coverage={cov:.4f}")
        if (rc != 0 or img.shape[:2] != (HEIGHT, WIDTH)
                or cov <= MIN_COVERAGE):
            raise AssertionError("--ssaa 2 app frame missing or empty")

    # -- 8. hygiene -------------------------------------------------------
    @phase("8 hygiene")
    def hygiene():
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "zrenderer_tpu", "PIL"))
        if loaded:
            raise AssertionError(f"reference modules loaded: {loaded[:5]}")
        print("  neither jax, the JAX package (zrenderer_tpu) nor PIL "
              "loaded")

    sources = {
        "k1": ("raster_small.cu", 2915), "k3": ("raster_hier.cu", 750),
        "k4": ("raster_binned.cu", 2253),
        "k4_coarse": ("raster_binned.cu", 2239),
        "k5": ("raster_hier.cu", 640), "k6": ("raster_binned.cu", 1520),
        "k2g": ("raster_small.cu", 2943), "k3g": ("raster_hier.cu", 1015),
        "k4g": ("raster_binned.cu", 2334), "k5g": ("raster_hier.cu", 717),
        "k6g": ("raster_binned.cu", 1554), "k2d": ("raster_small.cu", 2970),
        "k3d": ("raster_hier.cu", 895), "k4d": ("raster_binned.cu", 2365),
        "k6d": ("raster_binned.cu", 1582),
        "k7": ("light_tiled.cu", "zrenderer_tpu/ops/light_kernel.py:227"),
        "k7_bf16": ("light_tiled.cu",
                    "zrenderer_tpu/ops/light_kernel.py:227"),
        "k8": ("overlay.cu", "zrenderer_tpu/ops/overlay_raster.py:328"),
        "k8b": ("overlay.cu", "zrenderer_tpu/ops/overlay_raster.py:467"),
        "k3b": ("raster_hier.cu", 976), "k9": ("raster_binned.cu", 2413),
        "k9g": ("raster_binned.cu", 2501), "k9d": ("raster_binned.cu", 2701),
        "k10g8": ("raster_group8.cu", f"{EXPERIMENTS}/raster_group8.py:692"),
        "k10g8g": ("raster_group8.cu", f"{EXPERIMENTS}/raster_group8.py:704"),
        "k10g8d": ("raster_group8.cu", f"{EXPERIMENTS}/raster_group8.py:716"),
        "k10vec": ("raster_vec.cu", f"{EXPERIMENTS}/raster_vec.py:347"),
        "k10vecg": ("raster_vec.cu", f"{EXPERIMENTS}/raster_vec.py:384"),
        "k10vis": ("raster_vis.cu", f"{EXPERIMENTS}/raster_vis_trans.py:393"),
        "k10trans": ("raster_vis.cu",
                     f"{EXPERIMENTS}/raster_vis_trans.py:654"),
        "k10hbm2": ("raster_twoclass.cu", f"{EXPERIMENTS}/raster_hbm2.py:254"),
        "k10scan": ("raster_twoclass.cu",
                    f"{EXPERIMENTS}/raster_scanline.py:487")}
    # The kernels the phases reached (every kernel, in a full run).
    measured = ("launches", "ms", "plain_ms", "bound_ms", "bound_by",
                "ms_render_animation", "shape", "plain_shape")
    kernels = []
    for key, (src, line) in sources.items():
        res = results[key]
        if set(res) == {"err"}:
            continue
        if isinstance(line, int):
            line = f"zrenderer_tpu/ops/raster_pallas.py:{line}"
        kernels.append({
            "name": key, "route": "cuda",
            "source": f"zrenderer_tpu_torch/csrc/{src}",
            "replaces": line,
            "launches": counts.get(key), "max_abs_err": res["err"],
            "ms": res.get("ms"), "plain_ms": res.get("plain_ms"),
            "bound_ms": res.get("bound_ms"), "bound_by": res.get("bound_by"),
            "library_ms": None, "ms_render_animation": res.get("anim_ms"),
            "shape": res.get("shape"),
            "plain_shape": res.get("plain_shape"),
            **{k: v for k, v in res.items()
               if k.endswith("_r2") or k in (
                   "pairs", "evals", "covered", "live_layers",
                   "ms_test_scene", "prepare_ms", "plain_s_1m", "resolve_ms",
                   "resolve_busy_ms", "resolve_bound_ms", "tall_pairs",
                   "short_pairs", "short_share", "entry_ops",
                   "entry_busy_ms", "entry_idle_share", "z_one_pixels_1m",
                   "tall_evals", "short_evals", "pad_pixels_1m",
                   "short_pass_ms", "tall_pass_ms", "k5_ms",
                   "k5_uncompacted_ms", "bound_ms_tiles", "smem_bytes",
                   "device_ops_per_call", "ms_soup1m", "evals_soup1m",
                   "registers", "item_records",
                   "bound_ms_soup1m", "wrapper_ms_soup1m", "bytes",
                   "bound_ms_inputs", "bytes_soup1m", "bound_ms_chunks",
                   "entry_prepare_ms", "entry_kernel_ms",
                   "entry_resolve_ms", "op_ms", "admitted", "ms_40k",
                   "wrapper_ms_40k", "bound_ms_40k", "evals_40k",
                   "bytes_40k")}})
    if PHASE_PREFIXES is None:
        missing = [(k["name"], f) for k in kernels for f in measured
                   if k[f] is None]
        if missing or len(kernels) != len(sources):
            raise AssertionError(f"kernels line: {len(kernels)} of "
                                 f"{len(sources)} kernels, unmeasured "
                                 f"{missing}")
    else:
        print(f"skipped phases (--phases {','.join(PHASE_PREFIXES)}): "
              f"{'; '.join(SKIPPED_PHASES) or 'none'}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
