"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and
``nvcc``. It

  1. prints the card (``nvidia-smi`` name and power limit), the torch and
     CUDA versions, the TF32 flags (asserted off) and whether the machine
     has ``ml_dtypes`` (the port does not use it);
  2. builds the hand-written kernels from ``src/repro_torch/csrc`` (one
     ``nvcc`` per source, in parallel) and prints the build time;
  3. holds each kernel against its plain PyTorch version on the card at the
     shapes resnet50@224 and the smollm-360m prefill and decode give it
     (max|d|/max|plain| <= 2e-5 in f32, <= 2e-2 in bf16; the dequant
     kernels bitwise, max|d| = 0), and times the kernel, the plain version
     and one library call with CUDA events; ``decode_attention``
     also over the Pallas sweep in its prefix form, a wrapped ring with a
     window, the int8 cache, a softcap, granite-moe-3b-a800m's heads,
     zamba2-2.7b's head dim 80, internvl2-76b's 64/8 heads of 128 (B 1, W
     512; B 4, W 4096), musicgen-medium's 24/24 heads and head dims 100,
     67 and 256, each row printing its
     split plan; ``flash_attention`` at smollm-360m's 64- and 2048-token
     prefills, granite-moe-3b-a800m's 512-token prefill (24/8 heads),
     zamba2-2.7b's head dim 80 in bf16 and f32 (1024 tokens, 32/32 heads),
     internvl2-76b's 320-token prefill (64/8 heads of 128),
     musicgen-medium's 512 frames (24/24 of 64), ragged S, head dims 32,
     67, 100, 128 and 256 with windows and softcaps, and a batch whose
     plan puts two query heads in a block, each row printing its
     ``plan_flash`` cut; ``winograd_tile_matmul`` at resnet50's four
     stages and two ragged shapes, each row printing its path, tile and
     blocks; the f32 ``matmul`` also at granite-moe-3b-a800m's router
     (decode at 1 and 4 tokens, a 512-token prefill), mamba2-2.7b's f32
     decode projections and its tied head reading ``embed`` K-major in
     place (decode and a 1024-token prefill), ragged and unaligned edges,
     each row printing its path, tile and split; the bf16 ``matmul`` also
     at the decode projections (M 1 and 4) of smollm-360m,
     granite-moe-3b-a800m and mamba2-2.7b, the prefill projections of
     granite (512 tokens) and mamba2 (1024), internvl2-76b's 320-token
     prefill (its MLP up (8192, 28672) and down (28672, 8192)
     projections and its untied head over 128256), the tied heads at
     decode and prefill reading
     ``embed`` K-major in place, and ragged, unaligned edges;
     ``gmm_blocks`` at granite-moe-3b-a800m's expert GEMMs (C 8 at decode,
     208 at a 512-token prefill) in bf16 and in f32 (each f32 row printing
     its ``plan_f32_gemm`` plan, each launch's output first handed a
     NaN-filled block), with ``group_sizes`` from a top-8-of-40
     routing of 1 and of 4 tokens and a clipped prefill, and over the
     Pallas sweep; for the bf16 ``matmul``, ``gmm_blocks``,
     ``decode_attention``, the f32 ``matmul``, ``flash_attention`` and
     ``winograd_tile_matmul`` two launches on the same
     inputs must give the same bits, and their device time (the calls
     replayed from a CUDA graph) is printed beside the host-timed one
     (``ssd_scan`` too, below);
     ``ssd_scan`` at mamba2-2.7b's S 1024 in bf16 from a zero and a
     random state, in f32, at B 4 and at S 512,
     zamba2-2.7b's N 64, a ragged shape in f32 and bf16 and the Pallas
     sweep (y and the final state, each row printing the blocks of its
     four phases, two launches bitwise equal, a device time);
     ``matmul_packed`` at resnet50's packed head, a tblock up projection
     (64,960)x(960,2560) in f32 and bf16 x (beside the f32 ``matmul``'s
     row of that shape) and ragged panels, and ``matmul_dequant_int8`` and
     ``matmul_dequant_int4`` at the resnet50 head, that projection, decode
     at M 1 and 8 and ragged tiles with an odd K, each row printing its
     ``plan_f32_gemm`` plan (and byte loader), two launches bitwise equal,
     a device time, each launch's output first handed a NaN-filled block
     (int8 beside ``torch._weight_int8pack_mm``); ``flash_attention_bwd``
     (the backward of prefill attention, three launches counted as one,
     along ``plan_flash_bwd``'s route) at smollm-360m's training attention
     (8 and 4 sequences of 512, 15/5 heads of 64) in bf16 and f32,
     zamba2-2.7b's training microbatch (4, 512, 32/32 heads of 80) in
     bf16, a windowed, softcapped bf16 shape of gemma2's kind (1, 1024,
     32/16, 128), a ragged S with a head of 67 and a window, and a
     256-wide bf16 head (the CUDA-core route), dq, dk and dv against
     ``flash_attention_bwd_plain`` fed the kernel forward's o and lse,
     two launches bitwise equal, each launch's three outputs first handed
     NaN-filled blocks, beside SDPA's backward through autograd (events;
     and, for both, the summed device time of the kernels a call
     launches by ``torch.profiler``, the ruler ``tools/kernel_ab.py``
     shares); the bf16 ``matmul`` also at the training path's backward
     GEMMs (dx reading w K-major in place, dw over 2048 tokens); the MoE
     backward's products at granite-moe-3b-a800m's training microbatch
     (2048 tokens, top-8 of 40, C 824) in bf16 and f32, under a top-8
     routing's group sizes and with every expert full: ``gmm_blocks``'
     dx (dh and dblk, the forward's weight read K-major in place) and
     ``gmm_blocks_dw`` (dwg and dwd, each expert contracted over its own
     rows, x and dy read in place along ``plan_gmm_dw``: the TMA +
     ``wgmma`` kernel in bf16; under the routed sizes once more with the
     rows past each group NaN; and two ragged shapes with an empty
     expert, rows past the groups NaN: off TMA's 16-byte grid on the bf16
     tile path, and d 200, n 72 on the TMA kernel), each beside
     ``torch.bmm`` on the masked blocks, two launches bitwise equal, each
     output handed a NaN-filled block, a device time, each row printing
     its plan; ``ssd_scan_bwd`` (the backward of the
     scan, five launches counted as one) at mamba2-2.7b's training
     microbatch (B 4, S 512, two 256-token chunks) in bf16 and f32,
     zamba2-2.7b's (N 64) in bf16, mamba2 at S 1024 from a random state
     under a nonzero gradient of the final state, a ragged bf16 shape
     (35 heads in groups of 2, P 48, N 96, Q 200) and a ragged one in
     bf16 and f32 (a 320-token chunk whose fifth row tile's dCB terms go
     through global memory, P 40, N 72),
     its seven gradients against ``ssd_scan_bwd_plain`` on the kernel
     forward's cum, CB and chunk-entry states, two launches bitwise
     equal, each output handed a NaN-filled block, a device time, each
     row printing its ``plan_ssd_bwd`` plan and each launch's device time
     (``torch.profiler``); then the archs path's shapes (``arch_rows``):
     the bf16 ``matmul`` at qwen3-32b's 512-token prefill (q projection
     (5120, 8192), MLP up (5120, 25600), untied head (5120, 151936)) and
     gemma2-27b's 4608-token one (MLP up (4608, 36864), the tied head over
     256000 reading ``embed`` K-major in place), beside ``torch.matmul``;
     ``flash_attention`` at gemma2's (1, 4608, 32/16, 128) with window 4096
     and softcap 50 (no library call) and qwen3-32b's (1, 512, 64/8, 128)
     beside SDPA; ``gmm_blocks`` at qwen3-moe-30b-a3b's expert GEMMs (E
     128, d 2048 -> 768 and 768 -> 2048) under a top-8-of-128 routing of
     one and four decode tokens (C 8) and of a 512-token prefill (C 64),
     beside ``torch.bmm`` on the masked blocks, each output first handed a
     NaN-filled block; all with two launches bitwise equal and a device
     time; with
     ``--kernels-only`` the script stops here (a first check of a new
     kernel, without the paths or a result line); with ``--paths`` and
     any of ``serving,moe,ssm,hybrid,archs`` it runs those paths alone
     after the build (the archs path after its kernel rows), then stops
     (exit 0, no result line);
  4. drives the CNN path: resnet50 at image 224, width 1.0, from
     ``build_cnn`` through ``ColdEngine(store_fmt="super")``, ``decide`` with
     the real profiler, then ``run_cold``, and two more ``run_cold``s under
     pinned plans (Winograd for every 3x3/s1 conv with the packed head;
     im2col for every conv with the direct head), each output held to an
     all-plain forward on the card (max|d|/max|ref| <= 1e-4); then the
     lossy CNN path: a second engine with ``allow_lossy=True``, ``decide``
     with ``SyntheticProfiler``, and ``run_cold`` with the head on the
     ``int8``, ``int4`` and ``bf16`` caches (im2col convs), each held to an
     all-plain forward whose head uses the same (dequantized) weights;
     then continuous mode (paper §3.5): a ``ContinuousSession`` on the
     same engine, K_cold the decided plan (or the pinned im2col plan where
     the decided plan already is K_warm on every weighted layer),
     ``cold_infer`` from a first read and ``warm_infer(wait=True)`` twice,
     each output held to the all-plain forward, the times beside
     ``run_warm``; it fails unless the layers whose K_warm differs all
     switched (at least one); then the fleet: ``FrontDoor(n_workers=2,
     device="cuda")`` serving resnet50@224 from two worker processes, an
     SD-card-class edge disk emulated under their local reads, on one
     plan decided with measured profiles under that disk and written into
     both workers' stores (so both and every restart hold it): a SIGKILL
     of the first worker right after a request is dispatched to it, the
     failover served from disk by the second (held to the all-plain
     forward), the restart, a cold start on the restarted worker raced
     against the second's RAM (peer layers must be fetched), and a warm
     run on each; every output bitwise equal to the failover's, and no
     request left in flight or queued. Each result carries its own
     request's kernel launches, which must add up to the plan's launches
     per forward times the forwards served;
  5. drives the cold-LLM path: smollm-360m at its full published width
     (d_model 960, 15/5 heads, d_ff 2560, vocab 49152) and ``LLM_DEPTH``
     blocks, random weights from seed 0, a 64-token prompt, from
     ``build_llm_graph`` through ``ColdEngine(store_fmt="super")``,
     ``decide`` with the real profiler, ``run_cold`` in nnv12 and
     sequential mode, ``run_cold`` under two pinned plans (``f32_direct``
     everywhere; ``bf16_cast`` from the bf16 cache everywhere), and
     ``run_warm``; each logits tensor is held to an all-plain forward on the
     card (atol 0.1, rtol 0.05: the reference's own gate for this graph),
     and the two pinned plans must give bitwise-equal logits; then the
     lossy LLM path at ``LOSSY_DEPTH`` blocks: ``allow_lossy=True``,
     ``decide`` with ``SyntheticProfiler``, the ``int8``, ``int4`` and
     ``bf16_cast`` caches, and ``run_cold`` under the decided plan and with
     every tblock and the head pinned to each cache, each held to an
     all-plain forward on the same dequantized weights (same gate); the
     cache bytes of the matmul layers must be >= 1.8x (int8) and >= 3x
     (int4) below ``bf16_cast``;
  6. drives the serving path: smollm-360m at full width and ``SERVE_DEPTH``
     blocks through ``ColdServer(device="cuda")`` -> ``add_model`` ->
     ``decide`` -> ``cold_start_llm(max_new_tokens=16)``: the first token
     must precede the last decode prep, at least one weight prep must
     overlap the exec chain, 16 tokens must come back, ``decode_attention``
     must launch once a block for every ``decode_step``, the prefill
     logits must pass the LLM gate and the KV reservation must leave the
     ``MemoryBudget``; the same cold start with an eager decode server
     (``graph=False``) is reported beside it (``decode_ready_s``, the
     decode's seconds); then teacher-forced ``decode_step`` over 48 tokens
     with the kernels against the plain versions (bf16 cache, int8 cache,
     a 32-entry window ring; LLM gate) and a ``BatchedServer(max_batch=4,
     max_len=512)`` run of 6 greedy requests, each of which must finish
     with its token count (agreement with the plain run is reported,
     and for each request that leaves it, its first flip); then gate (a)
     on the bf16 cache, a 32-entry window ring past its wrap and the int8
     cache. Every ``BatchedServer`` on the card replays one CUDA graph a
     decode step (captured once, at its first step; the line of each run
     prints the capture's seconds), but for the runs with a Python hook
     in the step (the MoE paths' recorded or replayed routing), which
     run eager (``graph=False``) and say so. Gate (a): a graphed and an
     eager ``BatchedServer(max_batch=2, max_len=64)`` on the same params
     take three requests (``LOCKSTEP_SHAPES``: three prompts replayed, a
     recycled slot, 58 decode steps to position 52) in lockstep; after
     every tick every decode's logits and every state leaf must be
     bitwise equal, the launch counts equal (the graphed server's counted
     through its replays) and the graphed server must capture once; ms a
     step eager and graphed and 8 more decodes of each under the profiler
     (busy, idle share) are printed;
  7. drives the moe family: granite-moe-3b-a800m at full width, 16 of
     its 32 layers (``MOE_DEPTH``, a cut), bf16, weights drawn on the
     card: ``forward``
     on a 512-token prompt against the all-plain forward, one MoE layer on
     identical inputs, decode by steps against ``forward`` on 32 tokens and
     the ``BatchedServer`` run of the serving phase; a bf16 rounding
     upstream of the f32 router can flip a near-tie between experts, so
     the logits gates compare runs under the same routing (one replays the
     other's experts) and the free-running kernel and plain forwards must
     share 90 % of their (token, expert) assignments; the kernels'
     batched run is repeated replaying the plain run's routing
     (reported), then gate (a); then the model in f32 at
     ``MOE_F32_DEPTH`` layers (a cut): ``forward`` on the 512-token
     prompt against the all-plain f32 forward under the same routing
     (``PATH_TOL`` relative to max|ref|); then
     the ssm family: mamba2-2.7b at full width, 32 of its 64 layers
     (``SSM_DEPTH``, a cut): in bf16 ``forward`` on 1024 tokens, each
     layer held to its plain version on the same input and the whole
     model's difference from the all-plain forward reported, and the same
     ``BatchedServer`` run and gate (a); in f32 at ``SSM_F32_DEPTH``
     layers (16, a
     cut) ``forward`` against the all-plain forward and decode by steps
     against ``forward`` over two 256-token chunks (LLM gate); then the
     hybrid family: zamba2-2.7b at full width (d_model 2560, 32/32 heads of 80,
     d_ff 10240, 80 SSM heads of P 64, N 64, vocab 32000 tied), all 54
     layers (``HYBRID_DEPTH``: 9 groups of 6 mamba blocks, each followed by
     the one shared attention block), bf16: ``forward`` on 1024 tokens,
     each mamba block and each of the 9 shared-block applications held to
     its plain version on the same input (lockstep), the whole model's
     difference from the all-plain forward and its amplification of the
     worst block's reported, the ``BatchedServer`` run of the request mix
     with the kernels (no plain run: at this amplification token
     agreement says where greedy ties fall) and gate (a); in f32 at
     ``HYBRID_F32_DEPTH`` layers (6, one group: a cut) ``forward``
     against the all-plain forward and decode by steps against
     ``forward`` over 256 tokens (LLM gate); then the input modes:
     musicgen-medium (all 48 layers, ``embeddings``: 512 frame
     embeddings from numpy seed 0, an untied head over 2048 codes), in
     bf16 ``forward`` with each block held to its plain version in
     lockstep and decode by steps over ``MUSICGEN_DECODE`` frames, the
     whole model's differences reported (it amplifies a block's rounding
     past the LLM gate), in f32 ``forward`` against the all-plain forward
     and decode by steps against ``forward`` (LLM gate); internvl2-76b
     (``vlm``, full width, ``VLM_DEPTH`` = 2 of its 80 layers, a cut: the
     whole model does not fit one card) ``forward`` on 256 prefix
     embeddings and 64 text tokens against the all-plain forward, then 32
     decode steps of text tokens against the all-plain decode (LLM gate);
     then the archs path (``archs_path``, ``ARCHS_RUN``): the four archs
     no other path runs, at full published width in bf16, each depth a
     cut for the run's time: qwen3-moe-30b-a3b (128 experts of d_ff 768,
     top-8, ``qk_norm``, 32/4 heads of 128 on d_model 2048, untied head
     over 151936) at 8 of its 48 layers through ``moe_model``, granite's
     gates with the batched mix and gate (a) (``forward`` on 512
     tokens, C 64,
     against the all-plain forward under the kernels' routing replayed,
     ``ROUTE_AGREE`` on the free-running routing, one MoE layer on
     identical inputs, decode by steps against ``forward`` on 32 tokens
     under the forward's routing, the prefill cache) and in f32 at 2
     layers against the all-plain f32 forward under the replayed routing
     (``PATH_TOL``); mistral-nemo-12b (32/8 heads of 128 on d_model 5120,
     untied head over 131072) at 8 of 40, gemma2-27b (local/global pairs,
     window 4096, softcaps 50 and 30, tied head over 256000) at 4 of 46
     (two pairs) on a 4608-token prompt, past its window, and qwen3-32b
     (``qk_norm``, 64/8 heads of 128 on d_model 5120, untied head over
     151936) at 4 of 64 through ``dense_model``: ``forward`` against the
     all-plain forward and 32 decode steps against the all-plain decode
     by steps (LLM gate), the prefill cache of a 32-token forward against
     the decode state, each block against its plain version in lockstep
     (reported beside the whole model's difference), a forward's and 8
     decode steps' device busy and idle, the ``BatchedServer`` mix
     against the plain versions' run (graphed both) and gate (a);
     qwen3-32b also in f32 at 2
     layers against the all-plain f32 forward (``PATH_TOL``); then
     training (``training_path``): smollm-360m at full width on
     ``SyntheticPipeline(batch 8, seq 512, microbatches 2, seed 0)``; in
     f32 at ``TRAIN_F32_DEPTH`` = 4 of its 32 layers (a cut of depth) one
     step's loss and every gradient leaf against torch autograd through
     the plain versions (loss 1e-5 relative, each leaf ``PATH_TOL`` of its
     max|ref|), ``remat`` bitwise equal to none, and a ``save_pytree`` /
     ``load_pytree`` round trip of params and AdamW state bitwise; in bf16
     at all 32 layers the loss within 1e-2 of plain's and each gradient
     leaf within 5e-2 (``TRAIN_BF16_TOL``; each block's gradients held in
     lockstep too), two ``make_train_step`` steps from one state bitwise
     equal, the loss falling over 20 steps on ``batch_at(0)``, tokens/s
     and a step's device busy and idle; then MoE training
     (``moe_training_path``): granite-moe-3b-a800m at full width on the
     same pipeline (2048 tokens a microbatch, expert blocks of C 824); in
     f32 at ``MOE_TRAIN_F32_DEPTH`` = 2 of its 32 layers (a cut of depth)
     one step's loss and every gradient leaf (router, experts, attention,
     norms, embed) against torch autograd through the plain versions under
     the kernel run's routing replayed (loss 1e-5 relative, each leaf
     ``PATH_TOL`` of its max|ref|), ``remat`` bitwise equal to none; in
     bf16 at ``MOE_TRAIN_DEPTH`` = 8 layers (a cut of depth)
     each leaf within ``TRAIN_BF16_TOL`` under the replayed routing (or
     each block in lockstep, the amplification printed), two steps
     bitwise equal, the loss falling over ``MOE_TRAIN_CURVE`` = 10 steps,
     ms a step, tokens/s, a step's device busy and idle; then SSM and
     hybrid training (``ssm_training_path``): mamba2-2.7b and zamba2-2.7b
     at full width on the same pipeline (two 256-token chunks a
     microbatch); in f32 at ``SSM_TRAIN_F32_DEPTH`` = 2 and
     ``HYBRID_TRAIN_F32_DEPTH`` = 6 layers (cuts of depth; zamba2 one
     group) one step's loss and every gradient leaf against torch autograd
     through the plain versions (loss 1e-5 relative, each leaf
     ``PATH_TOL``), ``remat`` (a mamba block, or a group with its shared
     block, a checkpoint) bitwise equal to none; in bf16 at
     ``SSM_TRAIN_DEPTH`` = 8 and ``HYBRID_TRAIN_DEPTH`` = 12 (two
     groups) each leaf within ``TRAIN_BF16_TOL`` or each block in
     lockstep (mamba blocks and each shared-block application, the
     amplification printed), two steps bitwise equal, the loss falling
     over ``SSM_TRAIN_CURVE`` = 10 steps (peak lr 3e-3; zamba2's at
     ``HYBRID_TRAIN_LR`` 1e-3 to below ``HYBRID_TRAIN_FALL`` of its
     first), ms a step, tokens/s, a step's device busy
     and idle; then the roofline phase (``roofline_path``):
     ``launch.dryrun.build_step``'s ``prefill_step`` on a (1,
     ``ROOFLINE_SEQ``) prompt, smollm-360m at all 32 layers and
     zamba2-2.7b at ``HYBRID_DEPTH``, counted by ``roofline.op_cost`` on
     the card and on meta (the counts must be equal), its compute and
     memory terms at the data-sheet rates against the device busy time
     (``torch.profiler``; roofline / busy <= ``ROOFLINE_SHARE``) and
     ``model_flops`` <= the counted flops. Three runs also collect the
     prefill cache (``forward(collect_cache=True)``): the moe path's
     32-token forward (against its decode under the forward's routing),
     the hybrid path's f32 forward over one chunk and the input-modes
     path's musicgen forwards (against ``decode_by_steps``): each one's
     logits bitwise equal to the forward without collecting, and every
     cache leaf within the LLM gate of the state its decode steps leave
     (musicgen bf16, whose decode the path only reports: reported). Each
     kernel row of a costed wrapper prints its cost function's flops and
     bytes (``_native.costed``) beside the row's own, within ``COST_TOL``
     where the row counts whole tensors;
  8. fails unless every kernel of a path launched during that path's runs
     (each path's launch counts are zeroed just before its runs and read
     just after; the fleet's are its served requests' own;
     ``gmm_blocks`` 3 times a layer per ``forward`` or
     ``decode_step``, ``ssd_scan`` once a mamba layer per ``forward``,
     ``flash_attention`` once an attention layer or shared-block
     application per ``forward``, ``decode_attention`` once an attention
     layer or application per ``decode_step`` (a graph replay counts as
     the step it replays: the server adds its capture's counts at each
     replay and takes back those of its warm-up and capture); the bf16
     ``matmul`` 7 L + 1
     times per ``forward`` or ``decode_step`` of a dense model of L layers
     (the f32 one as many times in its f32 runs), the MoE router's f32
     ``matmul`` once a layer; a training step's
     ``flash_attention_bwd`` once a layer a microbatch, ``flash_attention``
     once (twice with remat) and the matmul 3 x (7 L + 1) times a
     microbatch (4 x 7 L + 3 with remat), no plain version called; an MoE
     training step's ``gmm_blocks`` 8 times a layer a microbatch (11 with
     remat), ``gmm_blocks_dw`` 3 times, the router's f32 matmul 3 times
     (4), the attention's projections 12 times (16) and the tied head's 3;
     an SSM or hybrid training step's ``ssd_scan`` once a mamba layer a
     microbatch (twice with remat), ``ssd_scan_bwd`` once, the shared
     block's ``flash_attention`` once an application (twice) and
     ``flash_attention_bwd`` once, the matmul 3 x F times (4 x F - 1), F
     = 6 a mamba layer + 7 a shared application + 1)
     and no kernel was demoted by the fault ladder.

Every run of a decided plan in the CNN and LLM phases (nnv12,
sequential, nnv12_nosteal) starts from the first arm's state: the store
reopened with its lazy CRC-32C audit pending and its files fsynced and
evicted from the page cache (``posix_fadvise(DONTNEED)``); each
``run_cold`` line prints its starting state. The sequential arm's run
lands the audit of the raw entries it reads before its timer starts, so
its line prints the audit's own seconds ("audit s"). One more nnv12 arm
follows it with that audit still landed (the store not reopened) and the
audit of the cache entries the decided plan reads landed (and timed)
first, its files evicted again: it pays no audit.

``LLM_DEPTH`` and ``SERVE_DEPTH`` (4 of smollm-360m's 32 blocks; 8
until the archs path came), ``LOSSY_DEPTH`` (8), ``MOE_DEPTH`` (16 of
granite's 32 layers), ``SSM_DEPTH`` and ``SSM_F32_DEPTH`` (32 and 16 of
mamba2's 64), ``HYBRID_F32_DEPTH`` (6 of zamba2's 54), ``VLM_DEPTH`` (2
of internvl2's 80), ``MUSICGEN_DECODE`` (16 steps), ``ARCHS_RUN``'s
depths (qwen3-moe-30b-a3b 8 of 48 and 2 in f32, mistral-nemo-12b 8 of
40, gemma2-27b 4 of 46, qwen3-32b 4 of 64 and 2 in f32) and the training
paths' depths are cuts for the run's time limit: those phases are host
work (``decide()``'s profiling, cache writes, the software CRC-32C, one
dispatch per op) and grow with depth; the kernels run at full width
either way.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Any failed phase exits
non-zero. With no CUDA device, or without the repository's sources beside
it, it exits non-zero before printing a result.
"""
from __future__ import annotations

import contextlib
import importlib.metadata
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# peak rates of an H100 PCIe (NVIDIA data sheet, dense): f32 without
# tensor cores, bf16 on the tensor cores, memory; an SXM card's come from
# repro_torch.launch.mesh, the port's own constants (``peak_rates``)
PCIE_PEAKS = {"float32": 51e12, "bfloat16": 756e12, "bytes": 2.0e12}


def peak_rates(name: str) -> dict:
    """The rates the bounds divide by: ``launch.mesh``'s H100 SXM
    constants, or the PCIe card's."""
    from repro_torch.launch import mesh as M

    if "PCIe" in name:
        return dict(PCIE_PEAKS)
    return {"float32": M.PEAK_FLOPS_F32, "bfloat16": M.PEAK_FLOPS_BF16,
            "bytes": M.HBM_BW}


KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
PATH_TOL = 1e-4
LLM_ATOL, LLM_RTOL = 0.1, 0.05
# cuts for the run's time, every one of them host work that grows with
# depth: the smollm-360m phases at 8 of its 32 blocks (at 32 one H100
# machine, whose host ran them 1.4-1.5x slower than others, took 1352.5
# s, past the 1200 s budget; at 16, with the hybrid and input-modes
# paths, 981.7-1013.2 s on two hosts and 1246.0 s on a slower one),
# granite-moe-3b-a800m at 16 of its 32 layers, mamba2-2.7b's forward
# path at 32 of its 64 in bf16 and 16 in f32 (64 and 32 until the ssm
# training path came: with it runs took 1066.3 s and, at 32 in bf16 on a
# slower host, 1104.9 s on an H100 SXM; its batched mix at 64 layers was
# ~90 s of host-bound decode steps, its 512 f32 decode steps at 32 layers
# ~40 s), musicgen-medium's decode at 32 steps and internvl2-76b at 2
# layers. With the roofline phase and the cache gates a run took 1122.7
# s, so since then musicgen's decode runs 16 steps and zamba2's f32 path
# 6 layers (one group; 12 before). To make room for the archs path the
# smollm-360m cold-LLM and serving phases run 4 blocks (8 before; a run
# with them at 8 took 930 s, and ~1105 s on its slowest host)
LLM_DEPTH = 4
LOSSY_DEPTH = 8
SERVE_DEPTH = 4
MOE_DEPTH = 16
MOE_F32_DEPTH = 4   # the f32 granite forward: a cut of its 32 layers
SSM_DEPTH = 32
SSM_F32_DEPTH = 16
HYBRID_DEPTH = 54
HYBRID_F32_DEPTH = 6  # the f32 zamba2 forward and decode: a cut of its 54
# musicgen-medium's decode steps against forward
MUSICGEN_DECODE = 16
# the roofline phase: a (1, 1024) prefill step of dryrun.build_step on the
# card, smollm-360m at all 32 layers and zamba2-2.7b at HYBRID_DEPTH; the
# most the roofline time (max of its compute and memory terms at the
# data-sheet rates) may be of the measured device busy time
ROOFLINE_SEQ = 1024
ROOFLINE_SHARE = 1.05
# the kernel rows: the cost function's flops and bytes within this share
# of the row's own count where the row counts whole tensors
COST_TOL = 0.01
# internvl2-76b's layers: a cut of its 80 (the whole model, ~141 GB in
# bf16, does not fit one 80 GB card; 4 layers and the two heads ~11 GB
# fit, 2 for the run's time)
VLM_DEPTH = 2
# the training path: smollm-360m in f32 at TRAIN_F32_DEPTH of its 32
# layers (a cut of depth only, for the f32 gate against plain) and in bf16
# at all 32; SyntheticPipeline(batch 8, seq 512, microbatches 2): 4096
# tokens a step; the loss curve's steps on batch_at(0); the bf16 gradient
# leaves' gate against plain (max|d|/max|ref|)
TRAIN_F32_DEPTH = 4
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = 8, 512, 2
TRAIN_CURVE = 20
TRAIN_BF16_TOL = 5e-2
# the moe training path: granite-moe-3b-a800m at full width on the same
# pipeline, f32 at MOE_TRAIN_F32_DEPTH of its 32 layers and bf16 at
# MOE_TRAIN_DEPTH (8 since the ssm training path came; 16 before), both
# cuts of depth for the run's time; the loss curve's steps; the expert
# blocks' capacity at a microbatch of 2048 tokens (top-8 of 40, capacity
# factor 2)
MOE_TRAIN_F32_DEPTH = 2
MOE_TRAIN_DEPTH = 8
MOE_TRAIN_CURVE = 10
MOE_TRAIN_C = 824
# the ssm and hybrid training path: mamba2-2.7b and zamba2-2.7b at full
# width on the same pipeline (two 256-token chunks a microbatch, so the
# reversed state passing carries a state across chunks); each depth a cut
# of depth for the 1200 s limit: mamba2 in bf16 at 8 of its 64 layers (16
# in a run of 1104.9 s) and in f32 at 2; zamba2 in bf16 at 12 of its 54
# (two groups of 6, the fewest that keep two, so the shared block's
# gradient sums two applications) and in f32 at 6 (one group); the loss
# curve's steps
SSM_TRAIN_DEPTH = 8
SSM_TRAIN_F32_DEPTH = 2
HYBRID_TRAIN_DEPTH = 12
HYBRID_TRAIN_F32_DEPTH = 6
SSM_TRAIN_CURVE = 10
# the hybrid's curve peaks at lr 1e-3 and must end below HYBRID_TRAIN_FALL
# of its first loss: at 3e-3 a bf16 zamba2-2.7b at 12 layers spikes after
# the warmup (the loss 1.19 at step 4, ~14 at step 6) under every rounding
# of the backward's sums tried, so whether its last loss ended below its
# first was a draw (PERF.md §6); at 1e-3 every such rounding falls from
# ~10.9 to ~1e-3, a ten-thousandth
HYBRID_TRAIN_LR = 1e-3
HYBRID_TRAIN_FALL = 1e-2
# the archs path: the four archs no other path runs, at full published
# width in bf16, each depth a cut for the run's time (not the card's
# memory: whole, mistral-nemo-12b is 24.5 GB in bf16, qwen3-moe-30b-a3b
# 61.1 GB). (arch, layers, prompt tokens, decode steps, f32 layers; 0: no
# f32 arm). qwen3-moe's 512-token prompt fills expert blocks of C 64;
# gemma2's four layers are two local/global pairs and its 4608-token
# prompt runs past the 4096 window, so the local layers' mask binds on
# the last 512 queries
ARCHS_RUN = [("qwen3-moe-30b-a3b", 8, 512, 32, 2),
             ("mistral-nemo-12b", 8, 512, 32, 0),
             ("gemma2-27b", 4, 4608, 32, 0),
             ("qwen3-32b", 4, 512, 32, 2)]
# whole-model MoE runs, kernels against plain: the share of (token, expert)
# assignments that must agree (a wrong hidden state routes near k/E = 0.2)
ROUTE_AGREE = 0.9
# cache bytes of the matmul layers (tblocks + LM head) below bf16_cast
LOSSY_BYTE_FLOORS = {"int8": 1.8, "int4": 3.0}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# the paths ``--paths`` runs alone, in the full run's order: each serves
# its models through graphed ``BatchedServer``s
ALONE = ("serving", "moe", "ssm", "hybrid", "archs")


def selected_paths():
    """``--paths serving,moe,ssm,hybrid,archs`` (any of them): the paths to
    run alone after the build, ``archs`` after its own kernel rows (None
    without the switch)."""
    argv = sys.argv[1:]
    if "--paths" not in argv:
        return None
    i = argv.index("--paths")
    paths = argv[i + 1].split(",") if i + 1 < len(argv) else []
    if not paths or any(x not in ALONE for x in paths):
        fail(f"--paths {','.join(paths) or '?'}: only "
             f"{','.join(ALONE)} run alone")
    return paths


@contextlib.contextmanager
def plain_kernels():
    """Every kernel wrapper of ``ops`` swapped for its plain version; the
    MoE layer's grouped FFN takes its plain forward under grad too, so that
    torch autograd differentiates it, not the hand-written backward."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant as Q
    from repro_torch.kernels.attention import (decode_attention_plain,
                                               flash_attention_bwd_plain,
                                               flash_attention_plain,
                                               plan_decode)
    from repro_torch.kernels.gmm import gmm_blocks_dw_plain, gmm_blocks_plain
    from repro_torch.kernels.matmul import matmul_plain
    from repro_torch.kernels.ssd import ssd_scan_plain
    from repro_torch.models import moe as MOE

    # under grad, the plain versions run under torch's autograd
    plain = {"matmul": matmul_plain, "flash_attention": flash_attention_plain,
             "flash_attention_bwd": flash_attention_bwd_plain,
             "decode_attention": decode_attention_plain,
             "dequant_int8": Q.dequant_int8_plain,
             "dequant_int4": Q.dequant_int4_plain,
             "matmul_dequant_int8": Q.matmul_dequant_int8_plain,
             "matmul_dequant_int4": Q.matmul_dequant_int4_plain,
             "gmm_blocks": gmm_blocks_plain,
             "gmm_blocks_dw": gmm_blocks_dw_plain, "ssd_scan": ssd_scan_plain}
    saved = {k: getattr(ops, k) for k in plain}
    for k, fn in plain.items():
        setattr(ops, k, fn)
    grouped_ffn = MOE._grouped_ffn
    MOE._grouped_ffn = MOE._grouped_ffn_fwd
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(ops, k, fn)
        MOE._grouped_ffn = grouped_ffn


# the batched-serving request mix of every LLM path: (prompt length, new
# tokens), prompts drawn from numpy seed 2
BATCH_SHAPES = [(8, 8), (64, 32), (23, 16), (40, 24), (12, 12), (57, 20)]


def batched_run(params, cfg, dev, plain: bool, hook: str = ""):
    """The ``BATCH_SHAPES`` requests, greedy, through a
    ``BatchedServer(max_batch=4, max_len=512)`` (slots recycled), which
    replays one CUDA graph a step (one capture, at its first step: fails
    otherwise). ``hook`` names a Python hook inside the step (a routing
    log), which a graph would run at its capture only: the server then
    runs eager (``graph=False``), and its line says so. Returns ({rid:
    tokens}, decode steps, seconds (the capture's included), the launch
    counts of the run, zeroed just before it, {rid: [(slot, f32 logits
    row)]} of every pick)."""
    import numpy as np

    from repro_torch.device import on_stream
    from repro_torch.kernels import ops
    from repro_torch.serving import BatchedServer, Request

    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n, _ in BATCH_SHAPES]
    srv = BatchedServer(params, cfg, max_batch=4, max_len=512, device=dev,
                        graph=not hook)
    for i, (p, (_, m)) in enumerate(zip(prompts, BATCH_SHAPES)):
        srv.submit(Request(rid=i, prompt=p, max_new_tokens=m))
    picks, pick = {}, srv._pick

    def recording(req, row):
        tok = pick(req, row)
        # copied on the server's stream: the row's memory goes back to
        # that stream's pool when the step's logits are freed
        with on_stream(srv.stream):
            picks.setdefault(req.rid, []).append(
                (next(s for s, r in enumerate(srv.slot_req) if r is req),
                 row.float().clone()))
        return tok

    srv._pick = recording
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with plain_kernels() if plain else contextlib.nullcontext():
        done = srv.run_until_drained()
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    srv.close()
    print(f"  BatchedServer run with the "
          f"{'plain versions' if plain else 'kernels'}: "
          + (f"eager ({hook} in the step)" if hook else
             f"graphed, {srv.captures} capture in {srv.capture_s:.3f} s"
             if srv.graphed else "eager (no graphs on the CPU)"))
    if srv.captures != (1 if srv.graphed else 0):
        fail(f"a graphed BatchedServer captured {srv.captures} graphs")
    return ({r.rid: r.out_tokens for r in done}, srv.decode_steps, dt,
            counts, picks)


# gate (a)'s requests, (prompt length, new tokens) through 2 slots, prompts
# from numpy seed 4: three prompts replayed, slot 1 recycled, 58 decode
# steps over 34 ticks, to position 52 (a 32-entry ring wraps)
LOCKSTEP_SHAPES = [(10, 16), (6, 12), (8, 24)]


def graph_against_eager(gates, params, cfg, dev, label) -> None:
    """Gate (a): a graphed and an eager ``BatchedServer(max_batch=2,
    max_len=64)`` on the same params take the ``LOCKSTEP_SHAPES`` requests
    in lockstep, tick by tick; after every tick each decode's logits and
    every state leaf must be bitwise equal, and the two runs' launch
    counts (the graphed one's counted through its replays) equal; the
    graphed one captures once. Prints ms a step of each (the graphed one
    without its capture), the capture's seconds, and the device busy time
    and idle share of 8 more decodes of each under the profiler (their
    launches count nowhere)."""
    import numpy as np
    import torch

    from repro_torch.device import on_stream
    from repro_torch.kernels import ops
    from repro_torch.serving import BatchedServer, Request

    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, size=n)
               for n, _ in LOCKSTEP_SHAPES]
    srvs, logs = [], []
    for graph in (True, False):
        srv = BatchedServer(params, cfg, max_batch=2, max_len=64, device=dev,
                            graph=graph)
        for i, (p, (_, m)) in enumerate(zip(prompts, LOCKSTEP_SHAPES)):
            srv.submit(Request(rid=i, prompt=p, max_new_tokens=m))
        log, decode = [], srv._decode

        def recording(tok, pos, srv=srv, log=log, decode=decode):
            lg = decode(tok, pos)
            with on_stream(srv.stream):  # the graph's output is overwritten
                log.append(lg.clone())
            return lg

        srv._decode = recording
        srvs.append(srv)
        logs.append(log)
    g, e = srvs
    wall, counts = [0.0, 0.0], [{}, {}]
    ticks, diverged = 0, None
    while ticks < 200 and any(s.queue or any(r is not None
                                             for r in s.slot_req)
                              for s in srvs):
        for i, srv in enumerate(srvs):
            before = ops.launch_counts()
            t0 = time.perf_counter()
            srv.step()
            torch.cuda.synchronize()
            wall[i] += time.perf_counter() - t0
            for k, n in ops.launch_counts().items():
                if n != before[k]:
                    counts[i][k] = counts[i].get(k, 0) + n - before[k]
        same = (len(logs[0]) == len(logs[1])
                and all(torch.equal(a, b) for a, b in zip(*logs))
                and all(torch.equal(g.state[k], e.state[k])
                        for k in g.state))
        if not same and diverged is None:
            diverged = ticks
        for log in logs:
            log.clear()
        ticks += 1
    steps = g.decode_steps
    print(f"  {label}: graph against eager, BatchedServer(max_batch=2, "
          f"max_len=64) in lockstep, prompts "
          f"{[n for n, _ in LOCKSTEP_SHAPES]}, max_new_tokens "
          f"{[m for _, m in LOCKSTEP_SHAPES]}: {steps} decode_steps over "
          f"{ticks} ticks to position {int(g.pos.max())}; every decode's "
          f"logits and every state leaf bitwise equal after every tick: "
          f"{diverged is None}"
          + ("" if diverged is None else f" (first differs at tick "
                                         f"{diverged})")
          + f"; ms a step eager {wall[1] * 1e3 / max(steps, 1):.3f}, "
          f"graphed {(wall[0] - g.capture_s) * 1e3 / max(steps, 1):.3f} "
          f"({g.captures} capture in {g.capture_s:.3f} s); launches "
          f"graphed {json.dumps(counts[0])}, eager {json.dumps(counts[1])}")
    gates.check(diverged is None, f"{label}: the graphed server's logits or "
                f"state left the eager one's at tick {diverged}")
    gates.check(steps == e.decode_steps >= 48 and not g.queue,
                f"{label}: {steps} and {e.decode_steps} decode steps, not "
                f"one count >= 48")
    gates.check(counts[0] == counts[1], f"{label}: the graphed run's "
                f"launches are not the eager run's")
    gates.check(g.captures == (1 if g.graphed else 0) and not e.captures,
                f"{label}: {g.captures} captures, not one a server")
    tok = np.zeros((2, 1), np.int64)
    for srv, kind in ((e, "eager"), (g, "graphed")):
        del srv._decode              # the class's own, unrecorded
        saved = ops.launch_counts()
        profile_steps(f"{label} {kind} decode B=2 W=64",
                      lambda i, srv=srv: srv._decode(tok, i), 8)
        ops.add_launch_counts({k: saved[k] - n
                               for k, n in ops.launch_counts().items()})
    del srvs, g, e


def report_batched(got, want, steps, dt, dt_p, picks, picks_p) -> bool:
    """Print a batched run against the plain kernels' run; True when every
    request finished with its token count. Greedy decoding diverges for
    good at the first flipped argmax, so for each request it also prints
    its slot, its logits rows up to its first flip against the LLM gate,
    and at the flip: max|d| of the two rows and how far the plain run
    preferred its token over the kernels' one (the plain margin). A
    recycled slot keeps its earlier requests' cache or state, so a
    request's history is the same in both runs only while the earlier
    requests of its slot gave the same tokens: the line says where not."""
    import torch

    agree = sum(a == b for i in got for a, b in zip(got[i], want.get(i, [])))
    total = sum(m for _, m in BATCH_SHAPES)
    finished = all(len(got.get(i, [])) == m
                   for i, (_, m) in enumerate(BATCH_SHAPES))
    print(f"  BatchedServer(max_batch=4, max_len=512): 6 requests, prompts "
          f"{[n for n, _ in BATCH_SHAPES]}, max_new_tokens "
          f"{[m for _, m in BATCH_SHAPES]}; all finished with their counts: "
          f"{finished}; {steps} decode_steps in {dt:.3f} s "
          f"({dt * 1e3 / steps:.3f} ms per step; plain "
          f"{dt_p * 1e3 / steps:.3f}); tokens agreeing with the plain "
          f"kernels' run: {agree}/{total}")
    margins = [float(torch.topk(r, 2).values.diff().abs()) for rs in
               picks_p.values() for _, r in rs]
    slot = {i: rs[0][0] for i, rs in picks.items() if rs}
    lines = []
    for i in sorted(got):
        a, b = got[i], want.get(i, [])
        n = min(len(a), len(b), len(picks.get(i, [])), len(picks_p.get(i, [])))
        j = next((k for k in range(n) if a[k] != b[k]), None)
        end = n if j is None else j + 1
        if end == 0:
            continue
        rows = torch.stack([r for _, r in picks[i][:end]])
        rows_p = torch.stack([r for _, r in picks_p[i][:end]])
        ok, _, _ = logits_gate(rows, rows_p)
        text = (f"req {i} slot {slot[i]}: rows in the gate "
                f"{int(ok.sum())}/{end}")
        if j is not None:
            at, at_p = rows[j], rows_p[j]
            text += (f", first flip at step {j}/{len(a)} (max|d| "
                     f"{float((at - at_p).abs().max()):.4f}, plain margin "
                     f"{float(at_p[b[j]] - at_p[a[j]]):.4f})")
        after = [r for r in sorted(got) if r < i and slot.get(r) == slot[i]
                 and got[r] != want.get(r)]
        if after:
            text += f", history differs (its slot served diverged {after})"
        lines.append(text)
    print(f"  per request, up to its first flip (the plain run's median "
          f"top-2 margin {float(torch.tensor(margins).median()):.4f}): "
          + "; ".join(lines))
    return finished


def profile_steps(label, step, n, extra=()):
    """Device busy time of ``step(0) .. step(n-1)`` under the profiler,
    kernels only (an aten op's device time is its kernels' again), and the
    five kernels with the most device time plus any whose name holds one of
    ``extra``; returns the busy ms a step (None where the profiler fails
    or shows no device time). Reported; only the roofline phase gates on
    it."""
    import torch

    try:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(n):
                step(i)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
        busy = sum(e.self_device_time_total for e in kern) / 1e3  # ms
        top = sorted(kern, key=lambda e: -e.self_device_time_total)[:5]
        named = [e for e in kern if any(x in e.key for x in extra)]
        top += [e for e in named if e not in top]
        # the summed device time of the kernels ``extra`` names (a kernel
        # of several phases, each a kernel of its own)
        sums = "".join(
            f"; '{x}' kernels together "
            f"{sum(e.self_device_time_total for e in named if x in e.key) / 1e3 / n:.4f}"
            f" ms/step in {sum(e.count for e in named if x in e.key) / n:g}"
            f" launches" for x in extra)
        print(f"  profiler, {label}: wall {wall * 1e3 / n:.3f} ms/step, "
              f"device busy {busy / n:.3f} ms/step (idle share "
              f"{1 - busy / (wall * 1e3):.3f}); kernels by device time: "
              + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3 / n:.4f}"
                          f" ms/step in {e.count / n:g} launches"
                          for e in top) + sums)
        return busy / n if busy > 0 else None
    except Exception as e:  # a breakdown only: report it, never fail on it
        print(f"  profiler: unavailable ({type(e).__name__}: {e})")
        return None


def evict(store) -> tuple:
    """Flush (fsync) every file of ``store`` and drop it from the page
    cache (``posix_fadvise(DONTNEED)``), after unmapping the pages an open
    reader's mmap holds (mapped pages are not dropped). Returns (files,
    bytes)."""
    import mmap

    mm = getattr(getattr(store, "_reader", None), "_mm", None)
    if mm is not None and not mm.closed:
        mm.madvise(mmap.MADV_DONTNEED)
    files = nbytes = 0
    for p in sorted(store.root.rglob("*")):
        if not p.is_file():
            continue
        fd = os.open(p, os.O_RDONLY)
        try:
            os.fsync(fd)
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)
        files, nbytes = files + 1, nbytes + p.stat().st_size
    return files, nbytes


def first_read_state(store) -> str:
    """Put ``store`` back where the first decided-plan arm found it: the
    reader closed, so the next read reopens the container with every lazy
    CRC-32C audit pending, and every file of the store flushed and evicted
    (``evict``). Returns the starting state for the arm's log line."""
    t0 = time.perf_counter()
    store.close()
    files, nbytes = evict(store)
    return (f"first read (store reopened, audit pending; {files} files, "
            f"{nbytes} B fsynced and evicted in "
            f"{time.perf_counter() - t0:.3f} s)")


# the decided-plan arms of the CNN and LLM phases: (label, run_cold mode,
# audit: "" for an arm that starts from a first read; "landed" for the
# nnv12 arm that follows the sequential arm and starts with the audit
# landed, files evicted)
DECIDED_ARMS = [("decided plan", "nnv12", ""),
                ("decided plan", "sequential", ""),
                ("decided plan, audit landed first", "nnv12", "landed")]


def decided_arm_state(eng, mode: str, audit: str) -> str:
    """The starting state of a decided-plan arm of ``eng``, for its log
    line. An nnv12 arm with no ``audit`` starts from a first read
    (``first_read_state``) and pays the lazy CRC-32C audit inside
    total_s. So does the sequential arm, but its run lands the audit of
    the raw entries (``warm_verify`` over the weighted layers, which reads
    them from disk) before its timer starts; here that audit is landed
    first and timed on its own ("audit s"), so the line shows what the arm
    did not pay. ``audit="landed"`` (the nnv12 arm right after the
    sequential one): the store is not reopened, so the raw entries'
    audit stays landed; the audit of every cache entry the decided plan
    reads (``audit_cached``: ``warm_verify`` never touches them) is landed
    and timed here, then the files are evicted again."""
    store, layers = eng.store, eng.layers
    if audit == "landed":
        if getattr(store, "_reader", None) is None:
            fail("the audit-landed arm must follow the sequential arm, "
                 "with the store still open")
        cached = [(l.spec.name, c.kernel)
                  for l, c in zip(layers, eng.plan.choices) if c.use_cache]
        t0 = time.perf_counter()
        bad = [e for e in cached if not store.audit_cached(*e)]
        cache_s = time.perf_counter() - t0
        if bad:
            fail(f"cache entries failed their CRC-32C audit: {bad}")
        files, nbytes = evict(store)
        return (f"audit landed (raw entries by the sequential arm, the "
                f"store kept open; audit s={cache_s:.3f} for the plan's "
                f"{len(cached)} cache entries; then {files} files, "
                f"{nbytes} B fsynced and evicted); pays no audit")
    start = first_read_state(store)
    if mode != "sequential":
        return start + "; pays the audit"
    t0 = time.perf_counter()
    store.warm_verify(l.spec.name for l in layers if l.spec.weight_shapes)
    return (f"{start}; audit s={time.perf_counter() - t0:.3f} (raw "
            f"entries), landed before the timer, the files left in the "
            f"page cache")


AS_LEFT = "as the previous arm left it"


def leaves(tree):
    """The tensors of a nested dict."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def wall_ms(fn, iters=10):
    """Host time of one call of ``fn``, synchronized, after a warm call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / iters


def plan_summary(choices) -> dict:
    summary = {}
    for kern, cached in choices:
        key = f"{kern}/{'cache' if cached else 'raw'}"
        summary[key] = summary.get(key, 0) + 1
    return summary


def materialize(eng, layer, kernel) -> None:
    """Write ``layer``'s cache entry for ``kernel`` unless it exists."""
    if not eng.store.has_cached(layer.spec.name, kernel):
        kern = next(k for k in eng._kernels_for(layer.spec)
                    if k.name == kernel)
        eng.store.write_cached(
            layer.spec.name, kernel,
            kern.transform(eng.store.read_raw(layer.spec.name), layer.spec))


def layer_weights(eng, layer, kernel, cached, dev) -> dict:
    """The weights a run of ``kernel`` executes for ``layer``, as device
    tensors: the cache entry (or the transform of the raw weights), with
    quantized tensors dequantized in numpy (``quant.dequantize_weight``)."""
    import numpy as np

    from repro_torch import bf16, quant

    kern = next(k for k in eng._kernels_for(layer.spec) if k.name == kernel)
    name = layer.spec.name
    entry = (eng.store.read_cached(name, kernel) if cached
             else kern.transform(eng.store.read_raw(name), layer.spec))
    groups, rest = quant.split_groups(entry)
    w = {k: bf16.to_tensor(np.array(v)).to(dev) for k, v in rest.items()}
    for base in groups:
        w[base] = bf16.to_tensor(quant.dequantize_weight(
            entry, base, layer.spec.weight_shapes[base])).to(dev)
    return w


def llm_path(dev, depth: int) -> dict:
    """smollm-360m cold prefill through the engine; returns the launch
    counts of the path's runs (zeroed just before them)."""
    import dataclasses

    import torch

    from repro_torch.checkpoint.integrity import crc32c_backend
    from repro_torch.configs import get_config
    from repro_torch.core.engine import ColdEngine
    from repro_torch.core.llm_graph import build_llm_graph
    from repro_torch.core.scheduler import Choice
    from repro_torch.executor.pool import reset_core_pool
    from repro_torch.ioengine import reset_io_engine, reset_stage_engine
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config("smollm-360m"), num_layers=depth)
    print(f"main path: {cfg.name} d_model={cfg.d_model} heads={cfg.num_heads}"
          f"/{cfg.num_kv_heads} head_dim={cfg.head_dim} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab_size} layers={cfg.num_layers} (of 32), "
          f"store_fmt=super")
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    layers, toks = build_llm_graph(cfg, params)
    print(f"  weights + graph: {time.perf_counter() - t0:.2f} s, prompt "
          f"{tuple(toks.shape)}")

    with plain_kernels():
        ref_out, _, _ = T.forward(
            T.to_device(params, dev),
            {"tokens": torch.from_numpy(toks).to(dev)}, cfg)
    torch.cuda.synchronize()
    del params
    shape = (1, toks.shape[1], cfg.vocab_size)

    def check_logits(label, out):
        out = out.detach()
        if tuple(out.shape) != shape or out.dtype != torch.float32 \
                or not torch.isfinite(out).all():
            fail(f"{label}: logits {tuple(out.shape)} {out.dtype} or "
                 f"non-finite")
        d = (out - ref_out).abs()
        ok = bool((d <= LLM_ATOL + LLM_RTOL * ref_out.abs()).all())
        print(f"  {label}: logits {shape}, max|d|={d.max().item():.4e} "
              f"max|ref|={ref_out.abs().max().item():.4e} "
              f"within atol {LLM_ATOL} rtol {LLM_RTOL}: {ok}")
        if not ok:
            fail(f"{label}: logits disagree with the all-plain forward")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_llm_") as tmp:
        t0 = time.perf_counter()
        eng = ColdEngine(layers, Path(tmp) / "store", store_fmt="super",
                         device=dev)
        print(f"  engine and store: {time.perf_counter() - t0:.2f} s "
              f"(CRC-32C backend: {crc32c_backend()})")
        t0 = time.perf_counter()
        stats = eng.decide(toks)
        print(f"  decide: {time.perf_counter() - t0:.2f} s, "
              f"profile_calls={stats['profile_calls']} "
              f"shape_classes={stats['shape_classes']} "
              f"io_interference={stats['io_interference']:.3f} "
              f"est_makespan_s={stats['est_makespan_s']:.6f}")
        if stats.get("degraded"):
            fail(f"decide degraded: {stats.get('error')}")
        print(f"  plan summary: "
              f"{json.dumps(plan_summary(stats['choices'].values()))}")
        print(f"  planned cold read bytes: "
              f"{json.dumps(stats['planned_cold_read_bytes'])}")
        # the bf16 cache of every layer, for the pinned bf16_cast plan
        weighted = [l for l in layers if l.spec.weight_shapes]
        t0 = time.perf_counter()
        for l in weighted:
            materialize(eng, l, "bf16_cast")
        eng.store.maintain()
        raw_b = sum(eng.store.raw_bytes(l.spec.name) for l in weighted)
        cache_b = sum(eng.store.cached_bytes(l.spec.name, "bf16_cast")
                      for l in weighted)
        print(f"  bf16 cache materialized: {time.perf_counter() - t0:.2f} s;"
              f" raw bytes {raw_b}, bf16 cache bytes {cache_b}")
        decided = eng.plan

        def pinned(kernel, cached):
            return replace(decided, choices=[
                Choice(kernel if kernel != "f32_direct"
                       or l.spec.op_type == "tblock" else "direct", cached)
                for l in layers])

        ops.reset_launch_counts()
        outs = {}
        for label, plan, mode, audit in [
                *((lb, None, m, a) for lb, m, a in DECIDED_ARMS),
                ("pinned f32_direct", pinned("f32_direct", False), "nnv12",
                 ""),
                ("pinned bf16_cast cached", pinned("bf16_cast", True),
                 "nnv12", "")]:
            before = ops.launch_counts()
            if plan is not None:
                eng.set_plan(plan)
            start = (decided_arm_state(eng, mode, audit)
                     if plan is None else AS_LEFT)
            r = eng.run_cold(toks, mode=mode)
            after = ops.launch_counts()
            delta = {k: after[k] - before[k] for k in after
                     if after[k] - before[k]}
            print(f"  run_cold [{label}, {mode}; start: {start}]: "
                  f"total_s={r.total_s:.4f} "
                  f"stage_seconds={json.dumps(r.stage_seconds())} "
                  f"launches={json.dumps(delta)}")
            check_logits(f"{label} {mode}", r.output)
            outs[label, mode] = r.output
        nnv12 = outs["decided plan", "nnv12"]
        seq = outs["decided plan", "sequential"]
        print(f"  nnv12 vs sequential: max|d|="
              f"{(nnv12 - seq).abs().max().item():.3e}")
        if not torch.equal(outs["pinned f32_direct", "nnv12"],
                           outs["pinned bf16_cast cached", "nnv12"]):
            fail("the f32_direct and bf16_cast plans differ")
        print("  f32_direct and bf16_cast logits: bitwise equal")
        eng.set_plan(decided)
        before = ops.launch_counts()
        warm = eng.run_warm(toks)
        after = ops.launch_counts()
        print(f"  run_warm: {warm:.4f} s (best of 3), launches="
              f"{json.dumps({k: after[k] - before[k] for k in after if after[k] - before[k]})}")
        counts = ops.launch_counts()
        print(f"  bf16 template launches by path (the runs above): "
              f"{json.dumps(ops.gemm_path_counts())}")
        repairs = eng.repairs.counts()
        open_breakers = eng.breaker.open_keys()
        print(f"  repairs={json.dumps(repairs)} open_breakers={open_breakers}")
        if repairs.get("kernel_demoted") or open_breakers:
            fail(f"kernels were demoted on the LLM path: {repairs} "
                 f"{open_breakers}")
        out = {k: counts[k] for k in ("flash_attention", "matmul_bf16")}
        for k, n in out.items():
            if n <= 0:
                fail(f"kernel {k} never launched on the LLM path")
        del eng
    reset_io_engine()
    reset_stage_engine()
    reset_core_pool()
    return out


def llm_lossy_path(dev, depth: int) -> dict:
    """smollm-360m cold prefill on the quantized caches
    (``ColdEngine(allow_lossy=True)``); returns the launch counts of the
    path's runs (zeroed just before them)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.engine import ColdEngine
    from repro_torch.core.llm_graph import (EmbedDirect, HeadDirect,
                                            TBlockF32Direct, build_llm_graph)
    from repro_torch.core.profiler import SyntheticProfiler
    from repro_torch.core.scheduler import Choice
    from repro_torch.executor.pool import reset_core_pool
    from repro_torch.ioengine import reset_io_engine, reset_stage_engine
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config("smollm-360m"), num_layers=depth)
    print(f"lossy LLM path: {cfg.name} full width, layers={depth} (of 32), "
          f"allow_lossy=True, store_fmt=super")
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    layers, toks = build_llm_graph(cfg, params)
    del params
    print(f"  weights + graph: {time.perf_counter() - t0:.2f} s")
    weighted = [l for l in layers if l.spec.weight_shapes]
    matmul_layers = [l for l in layers if l.spec.op_type in ("tblock",
                                                             "lmhead")]
    shape = (1, toks.shape[1], cfg.vocab_size)
    direct = {"embed": EmbedDirect(), "tblock": TBlockF32Direct(),
              "lmhead": HeadDirect()}

    with tempfile.TemporaryDirectory(prefix="chip_smoke_lossy_llm_") as tmp:
        t0 = time.perf_counter()
        eng = ColdEngine(layers, Path(tmp) / "store", store_fmt="super",
                         allow_lossy=True, device=dev)
        eng.profiler_factory = SyntheticProfiler
        print(f"  engine and store: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        stats = eng.decide(toks, calibrate_interference=False)
        print(f"  decide (SyntheticProfiler): {time.perf_counter() - t0:.2f}"
              f" s, profile_calls={stats['profile_calls']} "
              f"shape_classes={stats['shape_classes']} "
              f"est_makespan_s={stats['est_makespan_s']:.6f}")
        if stats.get("degraded"):
            fail(f"decide degraded: {stats.get('error')}")
        print(f"  plan summary: "
              f"{json.dumps(plan_summary(stats['choices'].values()))}")
        print(f"  planned cold read bytes: "
              f"{json.dumps(stats['planned_cold_read_bytes'])}")
        decided = eng.plan
        t0 = time.perf_counter()
        for l in weighted:
            for kernel in ("bf16_cast", "int8", "int4"):
                if l.spec.op_type != "embed" or kernel == "bf16_cast":
                    materialize(eng, l, kernel)
        eng.store.maintain()
        print(f"  int8, int4 and bf16_cast caches materialized: "
              f"{time.perf_counter() - t0:.2f} s")

        def pinned(kernel):
            return replace(decided, choices=[
                Choice("bf16_cast" if l.spec.op_type == "embed" else kernel,
                       True) for l in layers])

        def plain_forward(plan):
            """All-plain forward on the weights the run reads, quantized
            ones dequantized, each cast to bf16 by the lossless kernels."""
            y = torch.from_numpy(toks).to(dev)
            with plain_kernels():
                for l, c in zip(layers, plan.choices):
                    w = layer_weights(eng, l, c.kernel, c.use_cache, dev)
                    y = direct[l.spec.op_type].execute(w, y, l.spec)
            torch.cuda.synchronize()
            return y

        # each pinned arm twice: the first run reads (and CRC-audits) its
        # extents for the first time, the second finds them read once
        arms = ("bf16_cast", "int8", "int4")
        ops.reset_launch_counts()
        outs, served, matmul_b, model_b = {}, {}, {}, {}
        for label, plan in ([("decided", decided)]
                            + [(a, pinned(a)) for a in arms]
                            + [(f"{a} again", pinned(a)) for a in arms]):
            eng.set_plan(plan)
            before, s0 = ops.launch_counts(), eng.store.bytes_served()
            r = eng.run_cold(toks)
            after = ops.launch_counts()
            served[label] = eng.store.bytes_served() - s0
            delta = {k: after[k] - before[k] for k in after
                     if after[k] - before[k]}
            cached = {l.spec.name: c for l, c in zip(layers, plan.choices)}
            matmul_b[label] = sum(
                eng.store.cached_bytes(l.spec.name, cached[l.spec.name].kernel)
                for l in matmul_layers if cached[l.spec.name].use_cache)
            model_b[label] = sum(
                eng.store.cached_bytes(l.spec.name, cached[l.spec.name].kernel)
                for l in weighted if cached[l.spec.name].use_cache)
            print(f"  run_cold [{label}, nnv12]: total_s={r.total_s:.4f} "
                  f"stage_seconds={json.dumps(r.stage_seconds())} "
                  f"launches={json.dumps(delta)} bytes_served={served[label]}"
                  f" cache bytes: matmul layers {matmul_b[label]}, "
                  f"whole model {model_b[label]}")
            out = r.output.detach()
            if tuple(out.shape) != shape or out.dtype != torch.float32 \
                    or not torch.isfinite(out).all():
                fail(f"lossy {label}: logits {tuple(out.shape)} {out.dtype} "
                     f"or non-finite")
            ref = plain_forward(plan)
            d = (out - ref).abs()
            ok = bool((d <= LLM_ATOL + LLM_RTOL * ref.abs()).all())
            print(f"    vs all-plain forward on the same weights: "
                  f"max|d|={d.max().item():.4e} "
                  f"max|ref|={ref.abs().max().item():.4e} within atol "
                  f"{LLM_ATOL} rtol {LLM_RTOL}: {ok}")
            if not ok:
                fail(f"lossy {label}: logits disagree with the all-plain "
                     f"forward")
            outs[label] = out
        counts = ops.launch_counts()
        for a in arms:
            if not torch.equal(outs[a], outs[f"{a} again"]):
                fail(f"lossy {a}: two runs of one plan differ")
        print("  each pinned arm's two runs: bitwise equal logits")
        base = outs["bf16_cast"].cpu().numpy().ravel()
        for arm, floor in LOSSY_BYTE_FLOORS.items():
            ratio_mm = matmul_b["bf16_cast"] / max(matmul_b[arm], 1)
            ratio_model = model_b["bf16_cast"] / max(model_b[arm], 1)
            ratio_served = served["bf16_cast"] / max(served[arm], 1)
            corr = float(np.corrcoef(outs[arm].cpu().numpy().ravel(),
                                     base)[0, 1])
            print(f"  {arm} against bf16_cast: matmul-layer cache bytes "
                  f"{ratio_mm:.4f}x below (gate >= {floor}x), whole-model "
                  f"cache bytes {ratio_model:.4f}x, bytes_served "
                  f"{ratio_served:.4f}x, logits correlation {corr:.6f}")
            if ratio_mm < floor:
                fail(f"{arm}: matmul-layer cache bytes only {ratio_mm:.4f}x "
                     f"below bf16_cast (< {floor}x)")
        repairs = eng.repairs.counts()
        open_breakers = eng.breaker.open_keys()
        print(f"  repairs={json.dumps(repairs)} open_breakers={open_breakers}")
        if repairs.get("kernel_demoted") or open_breakers:
            fail(f"kernels were demoted on the lossy LLM path: {repairs} "
                 f"{open_breakers}")
        out = {k: counts[k] for k in ("dequant_int8", "dequant_int4")}
        for k in ("dequant_int8", "dequant_int4", "matmul_bf16",
                  "flash_attention"):
            if counts[k] <= 0:
                fail(f"kernel {k} never launched on the lossy LLM path")
        del eng
    reset_io_engine()
    reset_stage_engine()
    reset_core_pool()
    return out


def serving_path(dev, depth: int) -> dict:
    """smollm-360m cold serving: ``ColdServer`` -> ``add_model`` ->
    ``decide`` -> ``cold_start_llm`` (streamed prefill, first token, packs,
    then decode on a ``BatchedServer``); then teacher-forced
    ``decode_step`` against the plain kernels (bf16 cache, int8 cache, a
    32-entry window ring over 48 positions) and a ``BatchedServer`` run
    with slots recycled. Returns the launch counts of the cold start
    (zeroed just before it). Launch counts are checked at the end, so a
    CPU rehearsal runs every part before it stops there."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.llm_graph import build_llm_graph
    from repro_torch.executor.llm_bridge import cold_start_llm
    from repro_torch.executor.pool import reset_core_pool
    from repro_torch.executor.server import ColdServer
    from repro_torch.ioengine import reset_io_engine, reset_stage_engine
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.models.runtime_flags import FLAGS
    from repro_torch.serving import BatchedServer, Request

    cfg = dataclasses.replace(get_config("smollm-360m"), num_layers=depth)
    print(f"serving path: {cfg.name} full width, layers={depth} (of 32), "
          f"ColdServer -> decide -> cold_start_llm(max_new_tokens=16) -> "
          f"BatchedServer")
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    layers, toks = build_llm_graph(cfg, params)
    print(f"  weights + graph: {time.perf_counter() - t0:.2f} s, prompt "
          f"{tuple(toks.shape)}")
    pdev = T.to_device(params, dev)
    del params
    gates = PathGates("serving path")
    gate = gates.check

    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        srv = ColdServer(Path(tmp) / "server", device=dev)
        eng = srv.add_model("smollm", layers, store_fmt="super")
        t0 = time.perf_counter()
        stats = srv.decide("smollm", toks)
        print(f"  decide: {time.perf_counter() - t0:.2f} s, "
              f"profile_calls={stats['profile_calls']} plan summary "
              f"{json.dumps(plan_summary(stats['choices'].values()))}")
        gate(not stats.get("degraded"), f"decide degraded: {stats.get('error')}")
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = cold_start_llm(eng, cfg, toks[0], max_new_tokens=16,
                             server=srv, model_name="smollm")
        wall = time.perf_counter() - t0
        cold_counts = ops.launch_counts()
        print(f"  bf16 template launches by path (cold start): "
              f"{json.dumps(ops.gemm_path_counts())}")
        n_dec = res.decode_ticks      # decode_step calls after decode-ready
        print(f"  cold_start_llm: wall {wall:.3f} s; first_token_s="
              f"{res.first_token_s:.4f} last_weight_prep_s="
              f"{res.last_weight_prep_s:.4f} decode_prep_s="
              f"{res.decode_prep_s:.4f} decode_ready_s="
              f"{res.decode_ready_s:.4f} overlapped_layers="
              f"{res.overlapped_layers} overlapped_packs="
              f"{res.overlapped_packs} decode_steps={res.decode_steps} "
              f"decode_s={res.decode_s:.4f} "
              f"({res.decode_s * 1e3 / max(n_dec, 1):.3f} ms per decoded "
              f"token over {n_dec} ticks)")
        print(f"  cold run stage_seconds="
              f"{json.dumps(res.run.stage_seconds())}")
        print(f"  tokens: {res.tokens}")
        print(f"  launches: "
              f"{json.dumps({k: n for k, n in cold_counts.items() if n})}")
        # the same cold start with an eager decode server (reported; its
        # launches count nowhere): what the graph's capture and replays
        # change in decode_ready_s and the decode's seconds
        saved = ops.launch_counts()
        eager = cold_start_llm(eng, cfg, toks[0], max_new_tokens=16,
                               server=srv, model_name="smollm", graph=False)
        ops.add_launch_counts({k: saved[k] - n
                               for k, n in ops.launch_counts().items()})
        for kind, r in (("graphed", res), ("eager", eager)):
            ready = r.decode_ready_s - max(r.first_token_s, r.decode_prep_s)
            tick = r.decode_s * 1e3 / max(r.decode_ticks, 1)
            print(f"  cold_start_llm, {kind} decode server: first_token_s="
                  f"{r.first_token_s:.4f} decode_prep_s="
                  f"{r.decode_prep_s:.4f} decode_ready_s="
                  f"{r.decode_ready_s:.4f} (ready - max(first token, last "
                  f"pack) {ready:.4f} s for {r.decode_steps - r.decode_ticks}"
                  f" steps) decode_s={r.decode_s:.4f} ({tick:.3f} ms a tick "
                  f"over {r.decode_ticks}); tokens as the graphed run's: "
                  f"{r.tokens == res.tokens}")
        del eager
        gate(res.first_token_before_last_prep,
             "first token not before the last decode prep")
        gate(res.overlapped_layers >= 1, "no weight prep overlapped")
        gate(len(res.tokens) == 16, f"{len(res.tokens)} tokens, not 16")
        gate(res.tokens[0] == res.first_token, "tokens[0] != first_token")
        gate(n_dec == len(res.tokens) - 3,
             f"{n_dec} ticks timed after decode-ready, not "
             f"{len(res.tokens) - 3}")
        gates.launched("cold start", "decode_attention",
                       cold_counts["decode_attention"],
                       depth * res.decode_steps)
        for k in ("flash_attention", "matmul_bf16"):
            gates.launched("cold start", k, cold_counts[k])
        # the streamed prefill's logits against an all-plain forward
        with plain_kernels():
            ref, _, _ = T.forward(
                pdev, {"tokens": torch.from_numpy(toks).to(dev)}, cfg)
        d = (res.run.output - ref).abs()
        ok = bool((d <= LLM_ATOL + LLM_RTOL * ref.abs()).all())
        print(f"  prefill logits vs all-plain forward: max|d|="
              f"{d.max().item():.4e} within atol {LLM_ATOL} rtol "
              f"{LLM_RTOL}: {ok}; first token {res.first_token}, plain "
              f"argmax {int(torch.argmax(ref[0, -1]))}")
        gate(ok, "serving prefill logits disagree with the plain forward")
        budget = srv.budget.snapshot()
        kv_left = sum(n for t, n in budget["by_tag"].items()
                      if t.startswith("kv:"))
        # the packed decode params stay charged, at their own bytes: a
        # sibling worker's warm-state fetch can take them
        packed = sum(int(v.nbytes) for st in srv._packed_state.values()
                     for v in st.values())
        charged = sum(n for t, n in budget["by_tag"].items()
                      if t.startswith("packed:"))
        print(f"  MemoryBudget after close: {json.dumps(budget)} "
              f"(KV reservations left: {kv_left} B; resident "
              f"{srv.resident_bytes()} B; packed decode params {packed} B, "
              f"charged {charged} B)")
        gate(packed > 0 and charged == packed,
             "the packed decode params are not charged at their bytes")
        gate(kv_left == 0
             and budget["used"] == srv.resident_bytes() + packed,
             "the KV reservation did not return to the budget")
        repairs = eng.repairs.counts()
        gate(not repairs.get("kernel_demoted") and not eng.breaker.open_keys(),
             f"kernels were demoted on the serving path: {repairs}")
        del srv, eng, res
    reset_io_engine()
    reset_stage_engine()
    reset_core_pool()

    # teacher-forced decode_step: kernels against the plain versions
    S, B = 48, 2
    tf_toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(B, S))).to(dev)

    def teacher_forced(c, plain):
        state = T.init_decode_state(c, B, S, device=dev)
        outs = []
        with plain_kernels() if plain else contextlib.nullcontext():
            for t in range(S):
                lg, state = T.decode_step(pdev, state,
                                          {"tokens": tf_toks[:, t:t + 1]}, t, c)
                outs.append(lg[:, 0])
        torch.cuda.synchronize()
        return torch.stack(outs, 1), state

    for arm, c, int8 in [("bf16 cache", cfg, False),
                         ("int8 cache", cfg, True),
                         ("window-32 ring", cfg.with_sliding_window(32), False)]:
        saved = FLAGS["kv_cache_int8"]
        FLAGS["kv_cache_int8"] = int8
        try:
            before = ops.launch_counts()["decode_attention"]
            t0 = time.perf_counter()
            got, state = teacher_forced(c, False)
            t_k = time.perf_counter() - t0
            launched = ops.launch_counts()["decode_attention"] - before
            t0 = time.perf_counter()
            want, _ = teacher_forced(c, True)
            t_p = time.perf_counter() - t0
        finally:
            FLAGS["kv_cache_int8"] = saved
        d = (got - want).abs()
        ok = bool(torch.isfinite(got).all()) and bool(
            (d <= LLM_ATOL + LLM_RTOL * want.abs()).all())
        print(f"  teacher-forced [{arm}]: {S} steps B={B} cache "
              f"{tuple(state['k'].shape)} {state['k'].dtype}; logits max|d|="
              f"{d.max().item():.4e} max|ref|={want.abs().max().item():.4e} "
              f"within atol {LLM_ATOL} rtol {LLM_RTOL}: {ok}; "
              f"{t_k * 1e3 / S:.3f} ms/step (plain {t_p * 1e3 / S:.3f})")
        gate(ok, f"teacher-forced {arm}: logits disagree with the plain run")
        gates.launched(f"teacher-forced {arm}", "decode_attention",
                       launched, depth * S)

    # where a decode step's time goes: device busy time under the profiler
    # (B=1 at the cold start's cache length; reported, not gated)
    state = T.init_decode_state(cfg, 1, 82, device=dev)
    one = tf_toks[:1]
    for t in range(4):  # warm
        T.decode_step(pdev, state, {"tokens": one[:, t:t + 1]}, t, cfg)
    profile_steps("8 decode steps B=1 W=82", lambda i: T.decode_step(
        pdev, state, {"tokens": one[:, 4 + i:5 + i]}, 4 + i, cfg), 8,
        extra=("decode_",))

    # BatchedServer: 6 greedy requests through 4 slots (recycled)
    got, steps, dt, counts, picks = batched_run(pdev, cfg, dev, plain=False)
    want, _, dt_p, _, picks_p = batched_run(pdev, cfg, dev, plain=True)
    gate(report_batched(got, want, steps, dt, dt_p, picks, picks_p),
         "a batched request did not finish with its token count")
    gates.launched("batched", "decode_attention", counts["decode_attention"],
                   depth * steps)
    # gate (a): graphed against eager, bitwise, on the bf16 cache, a
    # 32-entry ring past its wrap and the int8 cache
    for arm, c, int8 in [("bf16 cache", cfg, False),
                         ("window-32 ring", cfg.with_sliding_window(32),
                          False),
                         ("int8 cache", cfg, True)]:
        saved = FLAGS["kv_cache_int8"]
        FLAGS["kv_cache_int8"] = int8
        try:
            graph_against_eager(gates, pdev, c, dev,
                                f"{cfg.name} [{arm}]")
        finally:
            FLAGS["kv_cache_int8"] = saved
    gates.finish()
    return {"decode_attention": cold_counts["decode_attention"]}


@contextlib.contextmanager
def routing_log(replay=None, probs_log=None):
    """Record every MoE ``route`` call's top-k experts, (T, k) on their
    device (no host sync), in call order. With ``replay`` (such a record), each call takes the
    recorded experts in place of its own top k, weighted by its own
    probabilities renormalized over them: two runs then make the same
    discrete choices and differ only by rounding. A list ``probs_log``
    also gets each call's router probabilities (T, E)."""
    from repro_torch.models import moe as MOE

    log = []
    route = MOE.route

    def recording(xf, router, cfg):
        probs, top_p, top_e = route(xf, router, cfg)
        if probs_log is not None:
            probs_log.append(probs.detach().clone())
        if replay is not None:
            top_e = replay[len(log)].to(probs.device)
            top_p = probs.gather(1, top_e)
            top_p = top_p / top_p.sum(dim=-1, keepdim=True)
        log.append(top_e.clone())
        return probs, top_p, top_e

    MOE.route = recording
    try:
        yield log
    finally:
        MOE.route = route


def routing_agreement(a, b):
    """Two runs' routing logs (lists of (T, k), the same calls in the same
    order): the share of (token, expert) assignments that agree, and (T,)
    True where a token took the same experts in every call."""
    same = total = 0
    alike = None
    for x, y in zip(a, b, strict=True):
        hit = (x[:, :, None] == y[:, None, :]).any(-1)   # x's expert in y's
        same, total = same + int(hit.sum()), total + hit.numel()
        alike = hit.all(-1) if alike is None else alike & hit.all(-1)
    return same / max(total, 1), alike


def near_ties(klog, plog, kprobs, pprobs, k: int) -> str:
    """Where two runs' routings first differ (layer l: upstream of it the
    runs differ by rounding only), each flipped token's gap between its
    k-th and (k+1)-th router logit (the first run's) against how far
    rounding moved its router logits between the runs (the spread of the
    two runs' log-probability differences over the experts, which bounds
    the change of any two experts' logit difference)."""
    import torch

    for l, (a, b) in enumerate(zip(klog, plog)):
        flip = ~(a[:, :, None] == b[:, None, :]).any(-1).all(-1)
        if flip.any():
            break
    else:
        return "the routings never differ"
    lk, lp = kprobs[l].clamp_min(1e-30).log(), pprobs[l].clamp_min(
        1e-30).log()
    srt = lk.sort(dim=-1, descending=True).values
    gap = (srt[:, k - 1] - srt[:, k])[flip]
    d = lk - lp
    moved = (d.max(-1).values - d.min(-1).values)[flip]
    within = int((gap <= moved).sum())
    every = (srt[:, k - 1] - srt[:, k]).median().item()
    return (f"first differing layer {l}: {int(flip.sum())} of {len(flip)} "
            f"tokens took other experts; their {k}th-{k + 1}th router logit "
            f"gap median {gap.median().item():.3e}, max {gap.max().item():.3e}"
            f" (all tokens' median {every:.3e});"
            f" their router logits moved by rounding between the runs: "
            f"median {moved.median().item():.3e}; gap <= move for {within}/"
            f"{int(flip.sum())}")


def logits_gate(got, ref):
    """(rows within atol/rtol of ``ref``, (rows,) bool; max|d|; max|ref|)
    over the logits' rows (every leading index)."""
    d = (got - ref).abs()
    ok = (d <= LLM_ATOL + LLM_RTOL * ref.abs()).reshape(
        -1, ref.shape[-1]).all(dim=1)
    return ok.cpu(), d.max().item(), ref.abs().max().item()


class PathGates:
    """A path's gates, reported together at its end (``finish``), so that a
    CPU rehearsal runs every part of the path first; ``main`` sums the
    launch counts of the path's main runs."""

    def __init__(self, name: str):
        self.name, self.failures, self.main = name, [], {}

    def check(self, ok, msg: str) -> None:
        if not ok:
            self.failures.append(msg)

    def launched(self, label, kernel, n, expected=None) -> None:
        """``kernel`` launched ``n`` times in ``label``: at least once, and
        ``expected`` times where that is given."""
        self.check(n > 0 and expected in (None, n),
                   f"{label}: {kernel} launched {n} times"
                   + ("" if expected is None else f", expected {expected}"))

    def add(self, counts) -> None:
        for k, n in counts.items():
            self.main[k] = self.main.get(k, 0) + n

    def logits(self, label, got, ref) -> None:
        """Every row of ``got`` within the LLM gate of ``ref``."""
        import torch

        ok, dmax, rmax = logits_gate(got, ref)
        print(f"  {label}: logits {tuple(got.shape)} max|d|={dmax:.4e} "
              f"max|ref|={rmax:.4e}; rows within atol {LLM_ATOL} rtol "
              f"{LLM_RTOL}: {int(ok.sum())}/{len(ok)}")
        self.check(bool(torch.isfinite(got).all()) and bool(ok.all()),
                   f"{label}: logits leave the gate")

    def relative(self, label, got, ref, tol=PATH_TOL) -> None:
        """``got`` within ``tol`` of ``ref`` relative to max|ref|: the f32
        gate (the bf16 LLM gate would pass a bf16 or TF32 product)."""
        import torch

        rmax = ref.abs().max().item()
        rel = (got - ref).abs().max().item() / max(rmax, 1e-30)
        print(f"  {label}: logits {tuple(got.shape)} max|d|/max|ref|="
              f"{rel:.3e} (max|ref|={rmax:.4e}), gate {tol}")
        self.check(bool(torch.isfinite(got).all()) and rel <= tol,
                   f"{label}: logits leave the f32 gate ({rel:.3e} > {tol})")

    def finish(self) -> None:
        if self.failures:
            fail(f"{self.name}: " + "; ".join(self.failures))


def rel_err(a, b) -> float:
    """max|a - b| / max|b|, in f32."""
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-30)).item()


def held(fn):
    """``fn()`` with the kernels and with their plain versions, on the same
    inputs: (the kernels' output, max|d|/max|plain|)."""
    y = fn()
    with plain_kernels():
        want = fn()
    return y, rel_err(y, want)


def draw_model(cfg, dev):
    """``cfg``'s random weights from seed 0, drawn on ``dev``."""
    import torch

    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    p = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    print(f"  {cfg.dtype} weights, {cfg.num_layers} layers: "
          f"{sum(t.numel() for t in leaves(p))} params drawn on {dev} in "
          f"{time.perf_counter() - t0:.2f} s")
    return p


def counted(gates, label, fn):
    """``fn()`` with the launch counts zeroed just before it and read (and
    added to the path's) just after; returns (its result, the counts)."""
    import torch

    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    gates.add(counts)
    print(f"  {label}: {(time.perf_counter() - t0) * 1e3:.1f} ms with the "
          f"kernels; launches "
          f"{json.dumps({k: n for k, n in counts.items() if n})}")
    return out, counts


def decode_by_steps(params, cfg, dev, key, inputs, n, with_state=False):
    """``n`` teacher-forced ``decode_step``s of ``inputs[:, t:t + 1]``
    under ``key`` ("tokens" or "embeds") from a zero state: (B, n, V), and
    the state the steps leave where ``with_state``."""
    import torch

    from repro_torch.models import transformer as T

    state = T.init_decode_state(cfg, inputs.shape[0], n, device=dev)
    outs = []
    for t in range(n):
        lg, state = T.decode_step(params, state, {key: inputs[:, t:t + 1]},
                                  t, cfg)
        outs.append(lg[:, 0])
    return (torch.stack(outs, 1), state) if with_state \
        else torch.stack(outs, 1)


def cache_pairs(cfg, cache, state, n):
    """(name, prefill cache leaf, its decode-state counterpart) of every
    leaf of ``forward(collect_cache=True)``'s cache: K/V rows 0..n-1 of
    the decode caches, the conv and SSM states."""
    rows = slice(0, n)
    if cfg.family in ("ssm", "hybrid"):
        (cx, cB, cC), ssm = cache["mamba"]
        out = [("conv_x", cx, state["conv_x"]),
               ("conv_B", cB, state["conv_B"]),
               ("conv_C", cC, state["conv_C"]), ("ssm", ssm, state["ssm"])]
        if cfg.family == "hybrid":
            k, v = cache["shared_kv"]
            out += [("shared_k", k, state["shared_k"][:, :, rows]),
                    ("shared_v", v, state["shared_v"][:, :, rows])]
        return out
    if cfg.local_global_pattern:
        (kl, vl), (kg, vg) = cache["local"], cache["global"]
        return [("k_local", kl, state["k_local"][:, :, rows]),
                ("v_local", vl, state["v_local"][:, :, rows]),
                ("k_global", kg, state["k_global"][:, :, rows]),
                ("v_global", vg, state["v_global"][:, :, rows])]
    k, v = cache["kv"]
    return [("k", k, state["k"][:, :, rows]), ("v", v, state["v"][:, :, rows])]


def cache_gates(gates, label, cfg, params, batch, logits, state, n,
                gated=True):
    """``forward(collect_cache=True)`` on ``batch``: its logits bitwise
    equal to ``logits`` (the same forward without collecting), and every
    cache leaf within the LLM gate (atol, rtol) of the state that ``n``
    decode steps left (reported only, not ``gated``, where the path holds
    its decode to nothing)."""
    import torch

    from repro_torch.models import transformer as T

    got, _, (cache, _) = T.forward(params, batch, cfg, collect_cache=True)
    torch.cuda.synchronize()
    same = torch.equal(got, logits)
    gates.check(same, f"{label}: collecting the cache changes the logits")
    worst, bad = (0.0, "-"), []
    for name, c, st in cache_pairs(cfg, cache, state, n):
        ok = tuple(c.shape) == tuple(st.shape) and bool(torch.isclose(
            c.float(), st.float(), rtol=LLM_RTOL, atol=LLM_ATOL).all())
        worst = max(worst, (rel_err(c, st), name))
        if not ok:
            bad.append(name)
    print(f"  {label}: prefill cache ({len(cache_pairs(cfg, cache, state, n))}"
          f" leaves) vs the state of {n} decode steps: worst max|d|/max|state|"
          f" {worst[0]:.3e} ({worst[1]}); leaves outside the LLM gate "
          f"{bad or 'none'}"
          + ("" if gated else " (reported, not gated)")
          + f"; logits bitwise equal to the forward without collecting: "
          f"{same}")
    if gated:
        gates.check(not bad, f"{label}: cache leaves {bad} leave the LLM "
                    f"gate of the decode state")
    del got, cache


def moe_path(dev, depth: int) -> dict:
    """granite-moe-3b-a800m at full width, ``depth`` layers, bf16, random
    weights from seed 0 drawn on the card, through ``moe_model``'s gates
    with a ``BatchedServer`` run and an f32 forward at ``MOE_F32_DEPTH``
    layers (a cut). Returns the launch counts of the main runs (the kernel
    forward, the decode steps, the batched server and the f32 forward),
    each zeroed just before it; launch gates are checked last, so a CPU
    rehearsal runs every part."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m"),
                              num_layers=depth)
    print(f"moe path: {cfg.name} full width (d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads, {cfg.num_experts} "
          f"experts of d_ff {cfg.d_ff}, top-{cfg.top_k}, vocab "
          f"{cfg.vocab_size}), layers={depth} (of 32), {cfg.dtype}: forward, "
          f"decode_step, BatchedServer")
    gates = PathGates("moe path")
    moe_model(gates, cfg, dev, 32, MOE_F32_DEPTH, batched=True)
    print(f"  moe path launches (forward + decode steps + batched + f32 "
          f"forward): "
          f"{json.dumps({k: n for k, n in gates.main.items() if n})}")
    gates.finish()
    return {"gmm_blocks": gates.main["gmm_blocks"],
            "matmul": gates.main["matmul"]}


def moe_model(gates, cfg, dev, of: int, f32_depth: int, batched: bool,
              pre: str = "", S: int = 512, Sd: int = 32) -> None:
    """An moe-family ``cfg`` (its depth cut from ``of`` layers) at full
    width, random weights from seed 0 drawn on ``dev``: ``forward`` on an
    ``S``-token prompt with the kernels against the all-plain forward; one
    MoE layer on identical inputs, kernel against plain; decode by steps
    against ``forward`` on an ``Sd``-token prompt and the prefill cache of
    that forward; where ``batched``, a ``BatchedServer`` run against the plain
    kernels' run. A bf16 difference upstream of the f32 router can flip a
    near-tie between experts, and a flipped token's hidden state reaches
    the other tokens through attention; so each whole-model logits gate
    compares two runs under the same routing (the second replays the
    first's experts), and the free-running kernel and plain forwards must
    share ``ROUTE_AGREE`` of their (token, expert) assignments. Last, the
    model in f32 at ``f32_depth`` layers (a cut): ``forward`` on the
    ``S``-token prompt against the all-plain f32 forward under the same
    routing (within ``PATH_TOL`` of max|ref|, the f32 gate), so that
    ``gmm_blocks``' f32 entry runs on the path. Each check and launch
    count goes to ``gates`` (labels led by ``pre``)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T

    depth = cfg.num_layers
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    print(f"  {pre}weights: {n_params} params drawn on {dev} in "
          f"{time.perf_counter() - t0:.2f} s")

    def agreement(label, a, b):
        share, alike = routing_agreement(a, b)
        print(f"  {pre}routing, {label}: {share:.4f} of (token, expert) "
              f"assignments agree; {int(alike.sum())}/{len(alike)} tokens "
              f"took the same experts in every layer")
        return share

    # forward on an S-token prompt: kernels against the all-plain forward
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(1, S))).to(dev)
    kprobs, pprobs = [], []
    with routing_log(probs_log=kprobs) as klog:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, aux, _ = T.forward(params, {"tokens": toks}, cfg)
        torch.cuda.synchronize()
        t_k = time.perf_counter() - t0
        counts = ops.launch_counts()
    gates.add(counts)
    print(f"  {pre}bf16 template launches by path (forward): "
          f"{json.dumps(ops.gemm_path_counts())}")
    with routing_log(probs_log=pprobs) as plog, plain_kernels():
        t0 = time.perf_counter()
        _, ref_aux, _ = T.forward(params, {"tokens": toks}, cfg)
        torch.cuda.synchronize()
        t_p = time.perf_counter() - t0
    with routing_log(replay=klog), plain_kernels():
        ref, _, _ = T.forward(params, {"tokens": toks}, cfg)
    print(f"  {pre}forward (1, {S}): {t_k * 1e3:.1f} ms with the kernels "
          f"(first call), {t_p * 1e3:.1f} ms all-plain; aux {aux.item():.5f} "
          f"(plain {ref_aux.item():.5f}); launches "
          f"{json.dumps({k: n for k, n in counts.items() if n})}")
    C = MOE.capacity(S, cfg)
    dropped = sum(int((torch.bincount(e.reshape(-1), minlength=cfg.num_experts)
                       - C).clamp_min(0).sum()) for e in klog)
    print(f"  {pre}capacity C={C} a block: {dropped} of "
          f"{S * cfg.top_k * depth} (token, expert) assignments dropped "
          f"over the {depth} layers")
    share = agreement("forward, kernels vs all-plain", klog, plog)
    if share < ROUTE_AGREE:
        print(f"  {pre}routing near-ties: "
              + near_ties(klog, plog, kprobs, pprobs, cfg.top_k))
    del kprobs, pprobs
    gates.check(share >= ROUTE_AGREE, f"{pre}only {share:.4f} of the "
                f"forward's routing assignments agree with the all-plain "
                f"forward's (< {ROUTE_AGREE})")
    gates.logits(f"{pre}forward (1, {S}) vs all-plain under the kernels' "
                 f"routing",
                 logits, ref)
    gates.launched(f"{pre}forward", "gmm_blocks", counts["gmm_blocks"],
                   3 * depth)
    gates.launched(f"{pre}forward", "flash_attention",
                   counts["flash_attention"],
                   depth)
    # the f32 router GEMM: one matmul launch a layer
    gates.launched(f"{pre}forward", "matmul", counts["matmul"], depth)
    del logits, ref
    profile_steps(f"{pre}forward (1, {S})", lambda i: T.forward(
        params, {"tokens": toks}, cfg), 1,
        extra=("gemm", "flash", "fa_bf16"))

    # one MoE layer on identical inputs (routing identical by construction)
    bp = T._layer(params["blocks"], 0)["moe"]
    xn = torch.randn((1, S, cfg.d_model), generator=torch.Generator(
        device=dev).manual_seed(4), device=dev).to(torch.bfloat16)
    with routing_log() as klog:
        y_k, _ = MOE.moe_apply(bp, xn, cfg)
    with routing_log() as plog, plain_kernels():
        y_p, _ = MOE.moe_apply(bp, xn, cfg)
    torch.cuda.synchronize()
    rel = rel_err(y_k, y_p)
    share, _ = routing_agreement(klog, plog)
    ms_k = wall_ms(lambda: MOE.moe_apply(bp, xn, cfg))
    with plain_kernels():
        ms_p = wall_ms(lambda: MOE.moe_apply(bp, xn, cfg))
    print(f"  {pre}one MoE layer on identical inputs (1, {S}, {cfg.d_model}), "
          f"C={MOE.capacity(S, cfg)}: max|d|/max|plain|={rel:.3e} (tol "
          f"{KERNEL_TOL['bfloat16']}); routing {share:.4f} alike; "
          f"{ms_k:.3f} ms with the kernels, {ms_p:.3f} ms plain")
    gates.check(rel <= KERNEL_TOL["bfloat16"]
                and bool(torch.isfinite(y_k).all()),
                f"{pre}one MoE layer disagrees with its plain version "
                f"({rel:.3e})")

    # decode by steps against forward on a short prompt: free-running for
    # the launch counts and the routing agreement, then under the
    # forward's routing for the logits gate. Decode routes one token at a
    # time and never fills a block (C = 8), while a forward drops the
    # tokens past C; so this forward runs with a capacity factor of E/k,
    # which gives C >= T and drops nothing (decode's C is 8 either way)
    dtoks = toks[:, :Sd]
    ncfg = dataclasses.replace(cfg, moe_capacity_factor=cfg.num_experts
                               / cfg.top_k)
    with routing_log() as flog:
        fl, _, _ = T.forward(params, {"tokens": dtoks}, ncfg)
    # the forward's choices in decode's call order (step-major)
    replay = [flog[l][t:t + 1] for t in range(Sd) for l in range(depth)]

    def decode(log_replay=None):
        state = T.init_decode_state(ncfg, 1, Sd, device=dev)
        outs = []
        with routing_log(replay=log_replay) as dlog:
            for t in range(Sd):
                lg, state = T.decode_step(
                    params, state, {"tokens": dtoks[:, t:t + 1]}, t, ncfg)
                outs.append(lg[:, 0])
        torch.cuda.synchronize()
        return torch.stack(outs, 1), [torch.cat(dlog[l::depth])
                                      for l in range(depth)], state

    ops.reset_launch_counts()
    dec, dlog, _ = decode()
    counts = ops.launch_counts()
    gates.add(counts)
    print(f"  {pre}bf16 template launches by path (decode, {Sd} steps): "
          f"{json.dumps(ops.gemm_path_counts())}")
    ok, dmax, _ = logits_gate(dec, fl)
    print(f"  {pre}decode by steps, free-running ({Sd} tokens, kernels): "
          f"max|d| vs forward {dmax:.4e}, rows within the gate "
          f"{int(ok.sum())}/{len(ok)}")
    agreement("decode by steps vs forward", dlog, flog)
    dec_r, _, dstate = decode(replay)
    gates.logits(f"{pre}decode by steps vs forward ({Sd} tokens, kernels) "
                 f"under the forward's routing", dec_r, fl)
    cache_gates(gates, f"{pre}prefill cache, forward (1, {Sd})", ncfg, params,
                {"tokens": dtoks}, fl, dstate, Sd)
    del dec_r, dstate
    gates.launched(f"{pre}decode", "gmm_blocks", counts["gmm_blocks"],
                   3 * depth * Sd)
    gates.launched(f"{pre}decode", "decode_attention",
                   counts["decode_attention"],
                   depth * Sd)
    gates.launched(f"{pre}decode", "matmul", counts["matmul"], depth * Sd)

    # where a decode step's time goes (B=1; reported, not gated)
    state = T.init_decode_state(cfg, 1, 64, device=dev)
    for t in range(4):  # warm
        T.decode_step(params, state, {"tokens": toks[:, t:t + 1]}, t, cfg)
    profile_steps(f"{pre}8 decode steps B=1", lambda i: T.decode_step(
        params, state, {"tokens": toks[:, 4 + i:5 + i]}, 4 + i, cfg), 8,
        extra=("decode_", "gemm_f32"))

    # BatchedServer: the serving path's request mix
    if batched:
        got, steps, dt, counts, picks = batched_run(params, cfg, dev,
                                                    plain=False)
        gates.add(counts)
        with routing_log() as blog:
            want, _, dt_p, _, picks_p = batched_run(
                params, cfg, dev, plain=True, hook="a routing log")
        gates.check(report_batched(got, want, steps, dt, dt_p, picks, picks_p),
                    "a batched request did not finish with its token count")
        print(f"  batched launches: "
              f"{json.dumps({k: n for k, n in counts.items() if n})}")
        gates.launched(f"{pre}batched", "gmm_blocks", counts["gmm_blocks"],
                       3 * depth * steps)
        gates.launched(f"{pre}batched", "decode_attention",
                       counts["decode_attention"],
                       depth * steps)
        gates.launched(f"{pre}batched", "matmul", counts["matmul"],
                       depth * steps)
        # why the kernels' tokens leave the plain run's: the kernels' run
        # again, replaying the plain run's routing (reported, not gated; its
        # launches are not counted)
        with routing_log(replay=blog):
            got_r, _, dt, _, picks = batched_run(
                params, cfg, dev, plain=False, hook="a replayed routing")
        print("  the kernels' batched run again, replaying the plain run's "
              "routing:")
        report_batched(got_r, want, steps, dt, dt_p, picks, picks_p)
        graph_against_eager(gates, params, cfg, dev,
                            pre.strip() or cfg.name)
    del params, state
    torch.cuda.empty_cache()

    # the f32 entry of gmm_blocks on the path: the model in f32 at full
    # width, its depth cut to f32_depth layers (to spare the run's time:
    # the bf16 runs above cover the whole depth), forward on the 512-token
    # prompt against the all-plain f32 forward under the kernels' routing
    c32 = dataclasses.replace(cfg, dtype="float32", num_layers=f32_depth)
    p32 = T.init_params(c32, torch.Generator(device=dev).manual_seed(0))
    with routing_log() as klog:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, _, _ = T.forward(p32, {"tokens": toks}, c32)
        torch.cuda.synchronize()
        t_k = time.perf_counter() - t0
        counts = ops.launch_counts()
    gates.add(counts)
    with routing_log(replay=klog), plain_kernels():
        ref, _, _ = T.forward(p32, {"tokens": toks}, c32)
    print(f"  {pre}f32 forward (1, {S}), layers={f32_depth} (of {of}, a "
          f"cut): {t_k * 1e3:.1f} ms with the kernels (first call); launches "
          f"{json.dumps({k: n for k, n in counts.items() if n})}")
    gates.relative(f"{pre}f32 forward (1, {S}) vs all-plain under the "
                   f"kernels' routing", logits, ref)
    gates.launched(f"{pre}f32 forward", "gmm_blocks", counts["gmm_blocks"],
                   3 * f32_depth)
    gates.launched(f"{pre}f32 forward", "flash_attention",
                   counts["flash_attention"], f32_depth)
    gates.launched(f"{pre}f32 forward", "matmul", counts["matmul"])
    del p32, logits, ref
    torch.cuda.empty_cache()


def ssm_path(dev, depth: int) -> dict:
    """mamba2-2.7b at full width, ``depth`` layers, random weights from
    seed 0 drawn on the card. In bf16, the served precision: ``forward`` on
    a 1024-token prompt with the kernels, each layer held to its plain
    version on the same input (lockstep through the layers), the whole
    model's difference from the all-plain forward reported (this
    random-weight model amplifies a rounding-size difference about 25-fold
    over its 64 layers, so no logits gate holds between two bf16 roundings
    of it), and a ``BatchedServer`` run against the plain kernels' run. In
    f32 at ``SSM_F32_DEPTH`` layers (a cut), where a rounding difference
    stays small: the kernels' forward against the all-plain forward, and
    decode by steps against ``forward`` over two 256-token chunks (the kernel's chunked
    scan against the recurrence of ``ssd_decode_step``), both within the
    LLM gate. Returns the launch counts of the main runs (both forwards,
    the decode steps and the batched server), each zeroed just before it;
    launch gates are checked last."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T

    base = dataclasses.replace(get_config("mamba2-2.7b"), num_layers=depth)
    print(f"ssm path: {base.name} full width (d_model {base.d_model}, inner "
          f"{base.ssm_inner}, {base.ssm_heads} heads of P {base.ssm_head_dim},"
          f" N {base.ssm_state}, chunk {base.ssm_chunk}, vocab "
          f"{base.vocab_size}), layers={depth} (of 64): forward, decode_step,"
          f" BatchedServer in bf16; at {SSM_F32_DEPTH} layers (a cut) forward"
          f" and decode against forward in f32")
    gates = PathGates("ssm path")

    def draw(dtype, layers):
        c = dataclasses.replace(base, dtype=dtype, num_layers=layers)
        return c, draw_model(c, dev)

    def counted_forward(params, cfg, toks):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, _, _ = T.forward(params, {"tokens": toks}, cfg)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        gates.add(counts)
        print(f"  bf16 template launches by path ({cfg.dtype} forward): "
              f"{json.dumps(ops.gemm_path_counts())}")
        print(f"  {cfg.dtype} forward {tuple(toks.shape)}: "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms with the kernels "
              f"(first call); launches "
              f"{json.dumps({k: n for k, n in counts.items() if n})}")
        gates.launched(f"{cfg.dtype} forward", "ssd_scan",
                       counts["ssd_scan"], cfg.num_layers)
        if cfg.dtype == "float32":  # six projections a layer, the tied head
            gates.launched(f"{cfg.dtype} forward", "matmul", counts["matmul"],
                           6 * cfg.num_layers + 1)
        return logits

    S = 1024
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, base.vocab_size, size=(1, S))).to(dev)

    # -- bf16 ----------------------------------------------------------------
    cfg, params = draw("bfloat16", depth)
    logits = counted_forward(params, cfg, toks)
    with plain_kernels():
        t0 = time.perf_counter()
        ref, _, _ = T.forward(params, {"tokens": toks}, cfg)
        torch.cuda.synchronize()
        t_p = time.perf_counter() - t0
    _, dmax, rmax = logits_gate(logits, ref)
    print(f"  bf16 forward (1, {S}) vs all-plain ({t_p * 1e3:.1f} ms): "
          f"max|d|={dmax:.4e} max|ref|={rmax:.4e} (reported, not gated)")
    gates.check(bool(torch.isfinite(logits).all()),
                "bf16 forward: non-finite")
    del logits, ref
    # each layer against its plain version on the same input, in lockstep
    x = params["embed"][toks]
    worst = (0.0, -1)
    for i in range(depth):
        bp = T._layer(params["blocks"], i)
        x, err = held(lambda: T._mamba_block_seq(bp, x, cfg)[0])
        worst = max(worst, (err, i))
    print(f"  bf16 layers in lockstep, each kernel layer against its plain "
          f"version on the same input: worst max|d|/max|plain| "
          f"{worst[0]:.3e} (layer {worst[1]}, tol {KERNEL_TOL['bfloat16']})")
    gates.check(worst[0] <= KERNEL_TOL["bfloat16"],
                f"bf16 layer {worst[1]} disagrees with its plain version "
                f"({worst[0]:.3e})")
    profile_steps(f"bf16 forward (1, {S})", lambda i: T.forward(
        params, {"tokens": toks}, cfg), 1, extra=("ssd",))
    state = T.init_decode_state(cfg, 1, 64, device=dev)
    for t in range(4):  # warm
        T.decode_step(params, state, {"tokens": toks[:, t:t + 1]}, t, cfg)
    profile_steps("8 bf16 decode steps B=1", lambda i: T.decode_step(
        params, state, {"tokens": toks[:, 4 + i:5 + i]}, 4 + i, cfg), 8)
    got, steps, dt, counts, picks = batched_run(params, cfg, dev,
                                                plain=False)
    gates.add(counts)
    want, _, dt_p, _, picks_p = batched_run(params, cfg, dev, plain=True)
    gates.check(report_batched(got, want, steps, dt, dt_p, picks, picks_p),
                "a batched request did not finish with its token count")
    print(f"  batched launches: "
          f"{json.dumps({k: n for k, n in counts.items() if n})}")
    # six projections a layer and the tied head, one launch each a step
    gates.launched("batched", "matmul_bf16", counts["matmul_bf16"],
                   (6 * depth + 1) * steps)
    graph_against_eager(gates, params, cfg, dev, cfg.name)
    del params, state
    torch.cuda.empty_cache()

    # -- f32 -----------------------------------------------------------------
    cfg, params = draw("float32", SSM_F32_DEPTH)
    logits = counted_forward(params, cfg, toks)
    with plain_kernels():
        ref, _, _ = T.forward(params, {"tokens": toks}, cfg)
    gates.logits(f"f32 forward (1, {S}) vs all-plain", logits, ref)
    del logits, ref
    Sd = 2 * cfg.ssm_chunk
    fl = counted_forward(params, cfg, toks[:, :Sd])
    state = T.init_decode_state(cfg, 1, Sd, device=dev)
    outs = []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for t in range(Sd):
        lg, state = T.decode_step(params, state, {"tokens": toks[:, t:t + 1]},
                                  t, cfg)
        outs.append(lg[:, 0])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    gates.add(counts)
    print(f"  f32 decode: {Sd} steps B=1 in {time.perf_counter() - t0:.2f} s; "
          f"launches {json.dumps({k: n for k, n in counts.items() if n})}")
    gates.logits(f"f32 decode by steps vs forward ({Sd} tokens, two chunks)",
                 torch.stack(outs, 1), fl)
    gates.launched("f32 decode", "matmul", counts["matmul"],
                   (6 * cfg.num_layers + 1) * Sd)
    profile_steps("8 f32 decode steps B=1", lambda i: T.decode_step(
        params, state, {"tokens": toks[:, Sd + i:Sd + i + 1]}, Sd + i, cfg),
        8, extra=("gemm_f32",))
    print(f"  ssm path launches (forwards + decode steps + batched): "
          f"{json.dumps({k: n for k, n in gates.main.items() if n})}")
    gates.finish()
    return {"ssd_scan": gates.main["ssd_scan"],
            "matmul": gates.main["matmul"]}


def hybrid_path(dev, depth: int, f32_depth: int) -> dict:
    """zamba2-2.7b at full width, ``depth`` layers (G = depth /
    shared_attn_every groups of mamba blocks, each followed by the one
    shared attention block), random weights from seed 0 drawn on the card.
    In bf16: ``forward`` on a 1024-token prompt with the kernels, each
    mamba block and each application of the shared block held to its plain
    version on the same input (lockstep), the whole model's difference
    from the all-plain forward reported beside the worst block's (the
    amplification; this random-weight model, like mamba2, is not held as a
    whole in bf16), and a ``BatchedServer`` run of the request mix, each
    request to finish with its token count. In f32 at ``f32_depth`` layers
    (a cut): ``forward`` against the all-plain forward, and decode by steps
    against ``forward`` over one 256-token chunk (the chunked scan and
    flash against the recurrence and ``decode_attention``), both within
    the LLM gate. Returns the launch
    counts of the main runs, each zeroed just before it; launch gates are
    checked last."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    base = dataclasses.replace(get_config("zamba2-2.7b"), num_layers=depth)
    every = base.shared_attn_every
    print(f"hybrid path: {base.name} full width (d_model {base.d_model}, "
          f"{base.num_heads}/{base.num_kv_heads} heads of {base.head_dim}, "
          f"d_ff {base.d_ff}, {base.ssm_heads} SSM heads of P "
          f"{base.ssm_head_dim}, N {base.ssm_state}, chunk {base.ssm_chunk}, "
          f"vocab {base.vocab_size} tied, the shared block after every "
          f"{every} mamba blocks), layers={depth} (of 54): forward, "
          f"decode_step, BatchedServer in bf16; at {f32_depth} layers (a "
          f"cut) forward and decode against forward in f32")
    gates = PathGates("hybrid path")

    def mm_per_token(c):
        # six projections a mamba block, seven a shared application, the
        # tied head
        return 6 * c.num_layers + 7 * (c.num_layers // every) + 1

    def forward_gates(c, label, counts):
        G = c.num_layers // every
        gates.launched(label, "ssd_scan", counts["ssd_scan"], c.num_layers)
        gates.launched(label, "flash_attention", counts["flash_attention"],
                       G)
        mm = "matmul" if c.dtype == "float32" else "matmul_bf16"
        gates.launched(label, mm, counts[mm], mm_per_token(c))

    S = 1024
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, base.vocab_size, size=(1, S))).to(dev)

    # -- bf16 ----------------------------------------------------------------
    cfg = base
    params = draw_model(cfg, dev)
    logits, counts = counted(gates, f"bf16 forward (1, {S})",
                             lambda: T.forward(params, {"tokens": toks},
                                               cfg)[0])
    forward_gates(cfg, "bf16 forward", counts)
    with plain_kernels():
        t0 = time.perf_counter()
        ref, _, _ = T.forward(params, {"tokens": toks}, cfg)
        torch.cuda.synchronize()
        t_p = time.perf_counter() - t0
    whole = rel_err(logits, ref)
    _, dmax, rmax = logits_gate(logits, ref)
    gates.check(bool(torch.isfinite(logits).all()),
                "bf16 forward: non-finite")
    del logits, ref
    # each block against its plain version on the same input, in lockstep
    x = params["embed"][toks]
    positions = torch.arange(S, dtype=torch.int32, device=dev)[None]
    worst = {"mamba": (0.0, -1), "shared": (0.0, -1)}
    for grp in range(depth // every):
        for j in range(every):
            i = grp * every + j
            bp = T._layer(params["blocks"], i)
            x, err = held(lambda: T._mamba_block_seq(bp, x, cfg)[0])
            worst["mamba"] = max(worst["mamba"], (err, i))
        x, err = held(lambda: T._attn_block_seq(
            params["shared"], x, cfg, positions, cfg.sliding_window)[0])
        worst["shared"] = max(worst["shared"], (err, grp))
    del x
    block = max(worst["mamba"][0], worst["shared"][0])
    print(f"  bf16 forward (1, {S}) vs all-plain ({t_p * 1e3:.1f} ms): "
          f"max|d|={dmax:.4e} max|ref|={rmax:.4e}, max|d|/max|ref| "
          f"{whole:.3e} (reported, not gated)")
    print(f"  bf16 blocks in lockstep, each against its plain version on the "
          f"same input: worst mamba block {worst['mamba'][0]:.3e} (layer "
          f"{worst['mamba'][1]}), worst shared-block application "
          f"{worst['shared'][0]:.3e} (group {worst['shared'][1]}), tol "
          f"{KERNEL_TOL['bfloat16']}; the whole model amplifies the worst "
          f"block's difference {whole / max(block, 1e-30):.1f}-fold")
    for kind, (err, at) in worst.items():
        gates.check(err <= KERNEL_TOL["bfloat16"],
                    f"bf16 {kind} block {at} disagrees with its plain "
                    f"version ({err:.3e})")
    profile_steps(f"bf16 forward (1, {S})", lambda i: T.forward(
        params, {"tokens": toks}, cfg), 1, extra=("ssd", "fa_bf16"))
    state = T.init_decode_state(cfg, 1, 64, device=dev)
    for t in range(4):  # warm
        T.decode_step(params, state, {"tokens": toks[:, t:t + 1]}, t, cfg)
    profile_steps("8 bf16 decode steps B=1", lambda i: T.decode_step(
        params, state, {"tokens": toks[:, 4 + i:5 + i]}, 4 + i, cfg), 8,
        extra=("decode_",))
    # the batched mix with the kernels only: at this amplification token
    # agreement with a plain run says where greedy ties fall, not whether
    # the kernels are right (the blocks above and the f32 gates say that)
    got, steps, dt, counts, _ = batched_run(params, cfg, dev, plain=False)
    gates.add(counts)
    finished = all(len(got.get(i, [])) == m
                   for i, (_, m) in enumerate(BATCH_SHAPES))
    print(f"  BatchedServer(max_batch=4, max_len=512): 6 requests, prompts "
          f"{[n for n, _ in BATCH_SHAPES]}, max_new_tokens "
          f"{[m for _, m in BATCH_SHAPES]}; all finished with their counts: "
          f"{finished}; {steps} decode_steps in {dt:.3f} s "
          f"({dt * 1e3 / steps:.3f} ms per step); launches "
          f"{json.dumps({k: n for k, n in counts.items() if n})}")
    gates.check(finished,
                "a batched request did not finish with its token count")
    gates.launched("batched", "decode_attention", counts["decode_attention"],
                   depth // every * steps)
    gates.launched("batched", "matmul_bf16", counts["matmul_bf16"],
                   mm_per_token(cfg) * steps)
    graph_against_eager(gates, params, cfg, dev, cfg.name)
    del params, state
    torch.cuda.empty_cache()

    # -- f32, a depth cut -----------------------------------------------------
    cfg = dataclasses.replace(base, dtype="float32", num_layers=f32_depth)
    params = draw_model(cfg, dev)
    logits, counts = counted(gates, f"f32 forward (1, {S})",
                             lambda: T.forward(params, {"tokens": toks},
                                               cfg)[0])
    forward_gates(cfg, "f32 forward", counts)
    with plain_kernels():
        ref, _, _ = T.forward(params, {"tokens": toks}, cfg)
    gates.logits(f"f32 forward (1, {S}), {f32_depth} layers, vs all-plain",
                 logits, ref)
    del logits, ref
    Sd = cfg.ssm_chunk
    fl, counts = counted(gates, f"f32 forward (1, {Sd})", lambda: T.forward(
        params, {"tokens": toks[:, :Sd]}, cfg)[0])
    forward_gates(cfg, f"f32 forward (1, {Sd})", counts)
    (dec, dstate), counts = counted(
        gates, f"f32 decode, {Sd} steps B=1",
        lambda: decode_by_steps(params, cfg, dev, "tokens", toks, Sd, True))
    gates.logits(f"f32 decode by steps vs forward ({Sd} tokens)", dec, fl)
    cache_gates(gates, f"f32 prefill cache, forward (1, {Sd})", cfg, params,
                {"tokens": toks[:, :Sd]}, fl, dstate, Sd)
    del dstate
    gates.launched("f32 decode", "decode_attention",
                   counts["decode_attention"], f32_depth // every * Sd)
    gates.launched("f32 decode", "matmul", counts["matmul"],
                   mm_per_token(cfg) * Sd)
    del params, fl, dec
    print(f"  hybrid path launches (forwards + decode steps + batched): "
          f"{json.dumps({k: n for k, n in gates.main.items() if n})}")
    gates.finish()
    return {k: gates.main[k] for k in ("ssd_scan", "flash_attention",
                                       "decode_attention", "matmul",
                                       "matmul_bf16")}


def gate_mm(gates, c, label, counts, n):
    """A dense model's matmul launches: seven projections a block and the
    head, once a forward or a token of decode (f32 ``matmul``, bf16
    ``matmul_bf16``)."""
    mm = "matmul" if c.dtype == "float32" else "matmul_bf16"
    gates.launched(label, mm, counts[mm], (7 * c.num_layers + 1) * n)


def gate_forward(gates, c, label, counts):
    """A dense model's forward: ``flash_attention`` once a layer, and the
    matmul as ``gate_mm``."""
    gates.launched(label, "flash_attention", counts["flash_attention"],
                   c.num_layers)
    gate_mm(gates, c, label, counts, 1)


def gate_decode(gates, c, label, counts, n):
    """``n`` decode steps of a dense model: ``decode_attention`` once a
    layer a step, and the matmul as ``gate_mm``."""
    gates.launched(label, "decode_attention", counts["decode_attention"],
                   c.num_layers * n)
    gate_mm(gates, c, label, counts, n)


def modes_path(dev, music_decode: int, vlm_depth: int) -> dict:
    """The ``embeddings`` and ``vlm`` input modes at full width, random
    weights from seed 0 drawn on the card. musicgen-medium (all 48 layers,
    untied head over 2048 codes), 512 frame embeddings (numpy seed 0): in
    bf16, ``forward`` with each block held to its plain version on the
    same input (lockstep) and decode by steps (an embedding a step) over
    the first ``music_decode`` frames, the whole model's differences from
    the all-plain forward and from ``forward`` reported (this random-weight
    model amplifies a block's rounding past the LLM gate over 48 layers);
    in f32, ``forward`` against the all-plain forward and decode by steps
    against ``forward``. internvl2-76b in bf16 at ``vlm_depth`` of its 80
    layers (a cut: the whole model, ~141 GB in bf16, does not fit one
    card): ``forward`` on 256 prefix embeddings and 64 text tokens against
    the all-plain forward, then 32 decode steps of text tokens against
    the all-plain decode. Every whole-model gate is the LLM gate. Returns
    the launch counts of the kernels' runs, each zeroed just before it;
    launch gates are checked last."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    gates = PathGates("input-modes path")

    # -- musicgen-medium: frame embeddings, untied head -----------------------
    base = get_config("musicgen-medium")
    print(f"input-modes path: {base.name} full width (d_model "
          f"{base.d_model}, {base.num_heads}/{base.num_kv_heads} heads of "
          f"{base.head_dim}, d_ff {base.d_ff}, untied head over "
          f"{base.vocab_size} codes), layers={base.num_layers} (of 48), input "
          f"{base.input_mode}: in bf16 forward on 512 frame embeddings with "
          f"each block held in lockstep, decode by steps over "
          f"{music_decode}; in f32 both against the all-plain forward and "
          f"forward")
    S, Sd = 512, music_decode
    emb = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, S, base.d_model)).astype(np.float32)).to(dev)
    positions = torch.arange(S, dtype=torch.int32, device=dev)[None]

    def musicgen_bf16(params, cfg, logits, ref, dec, fl):
        """Each block against its plain version on the same input; the
        whole model's differences reported beside the worst block's."""
        whole = rel_err(logits, ref)
        ok, dmax, rmax = logits_gate(logits, ref)
        ok_d, dmax_d, _ = logits_gate(dec, fl)
        x, worst = emb.to(torch.bfloat16), (0.0, -1)
        for i in range(cfg.num_layers):
            bp = T._layer(params["blocks"], i)
            x, err = held(lambda: T._attn_block_seq(
                bp, x, cfg, positions, cfg.sliding_window)[0])
            worst = max(worst, (err, i))
        print(f"  musicgen bf16 forward (1, {S}) vs all-plain: max|d|="
              f"{dmax:.4e} max|ref|={rmax:.4e}, rows within the LLM gate "
              f"{int(ok.sum())}/{len(ok)}; decode by steps vs forward "
              f"({Sd} frames): max|d|={dmax_d:.4e}, rows "
              f"{int(ok_d.sum())}/{len(ok_d)} (both reported, not gated)")
        print(f"  musicgen bf16 blocks in lockstep, each against its plain "
              f"version on the same input: worst {worst[0]:.3e} (layer "
              f"{worst[1]}, tol {KERNEL_TOL['bfloat16']}); the whole model "
              f"amplifies it {whole / max(worst[0], 1e-30):.1f}-fold "
              f"(max|d|/max|ref| {whole:.3e})")
        gates.check(worst[0] <= KERNEL_TOL["bfloat16"]
                    and bool(torch.isfinite(logits).all()),
                    f"musicgen bf16 block {worst[1]} disagrees with its "
                    f"plain version ({worst[0]:.3e})")
        profile_steps(f"musicgen bf16 forward (1, {S})", lambda i: T.forward(
            params, {"embeds": emb}, cfg), 1, extra=("fa_bf16",))
        state = T.init_decode_state(cfg, 1, 64, device=dev)
        for t in range(4):  # warm
            T.decode_step(params, state, {"embeds": emb[:, t:t + 1]}, t, cfg)
        profile_steps("8 musicgen bf16 decode steps B=1", lambda i:
                      T.decode_step(params, state,
                                    {"embeds": emb[:, 4 + i:5 + i]}, 4 + i,
                                    cfg), 8, extra=("decode_",))

    for cfg in (base, dataclasses.replace(base, dtype="float32")):
        dt = cfg.dtype
        params = draw_model(cfg, dev)
        logits, counts = counted(gates, f"musicgen {dt} forward (1, {S})",
                                 lambda: T.forward(params, {"embeds": emb},
                                                   cfg)[0])
        gate_forward(gates, cfg, f"musicgen {dt} forward", counts)
        with plain_kernels():
            ref, _, _ = T.forward(params, {"embeds": emb}, cfg)
        fl = T.forward(params, {"embeds": emb[:, :Sd]}, cfg)[0]
        (dec, dstate), counts = counted(
            gates, f"musicgen {dt} decode, {Sd} steps B=1",
            lambda: decode_by_steps(params, cfg, dev, "embeds", emb, Sd,
                                    True))
        gate_decode(gates, cfg, f"musicgen {dt} decode", counts, Sd)
        # bf16: the path reports its decode against forward, not gated
        cache_gates(gates, f"musicgen {dt} prefill cache, forward (1, {Sd})",
                    cfg, params, {"embeds": emb[:, :Sd]}, fl, dstate, Sd,
                    gated=dt == "float32")
        del dstate
        if dt == "float32":
            gates.logits(f"musicgen f32 forward (1, {S}) vs all-plain",
                         logits, ref)
            gates.logits(f"musicgen f32 decode by steps vs forward ({Sd} "
                         f"frames)", dec, fl)
        else:
            musicgen_bf16(params, cfg, logits, ref, dec, fl)
        del params, logits, ref, fl, dec
        torch.cuda.empty_cache()

    # -- internvl2-76b: patch embeddings in front of the text -----------------
    cfg = dataclasses.replace(get_config("internvl2-76b"),
                              num_layers=vlm_depth)
    P, Tt, Sd = cfg.num_prefix_embeds, 64, 32
    print(f"input-modes path: {cfg.name} full width (d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, untied vocab {cfg.vocab_size}), layers={vlm_depth} "
          f"(of 80, a cut), input {cfg.input_mode}, {cfg.dtype}: forward on "
          f"{P} prefix embeddings and {Tt} text tokens, {Sd} decode steps")
    params = draw_model(cfg, dev)
    rng = np.random.default_rng(1)
    pre = torch.from_numpy((rng.standard_normal((1, P, cfg.d_model)) * 0.02)
                           .astype(np.float32)).to(dev)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, Tt))).to(dev)
    batch = {"prefix_embeds": pre, "tokens": toks}
    logits, counts = counted(gates, f"internvl2 forward (1, {P}+{Tt})",
                             lambda: T.forward(params, batch, cfg)[0])
    gate_forward(gates, cfg, "internvl2 forward", counts)
    with plain_kernels():
        ref, _, (_, mask) = T.forward(params, batch, cfg)
    gates.check(float(mask[:, :P].sum()) == 0 and float(mask.sum()) == Tt,
                "internvl2: the loss mask is not 0 over the prefix")
    gates.logits(f"internvl2 forward (1, {P}+{Tt}) vs all-plain", logits, ref)
    del logits, ref
    dec, counts = counted(gates, f"internvl2 decode, {Sd} steps B=1",
                          lambda: decode_by_steps(params, cfg, dev, "tokens",
                                                  toks, Sd))
    with plain_kernels():
        want = decode_by_steps(params, cfg, dev, "tokens", toks, Sd)
    gates.logits(f"internvl2 decode, {Sd} steps, vs all-plain decode", dec,
                 want)
    gate_decode(gates, cfg, "internvl2 decode", counts, Sd)
    profile_steps(f"internvl2 forward (1, {P + Tt})", lambda i: T.forward(
        params, batch, cfg), 1, extra=("fa_bf16",))
    state = T.init_decode_state(cfg, 1, 64, device=dev)
    for t in range(4):  # warm
        T.decode_step(params, state, {"tokens": toks[:, t:t + 1]}, t, cfg)
    profile_steps("8 internvl2 decode steps B=1", lambda i: T.decode_step(
        params, state, {"tokens": toks[:, 4 + i:5 + i]}, 4 + i, cfg), 8,
        extra=("decode_",))
    del params, state, dec, want
    torch.cuda.empty_cache()
    print(f"  input-modes path launches (forwards + decode steps): "
          f"{json.dumps({k: n for k, n in gates.main.items() if n})}")
    gates.finish()
    return {k: gates.main[k] for k in ("flash_attention", "decode_attention",
                                       "matmul", "matmul_bf16")}


def dense_model(gates, cfg, dev, S: int, Sd: int, f32_depth: int,
                pre: str, batched: bool = False) -> None:
    """A dense ``cfg`` at full width, random weights from seed 0 drawn on
    ``dev``: ``forward`` on an ``S``-token prompt (numpy seed 3) with the
    kernels against the all-plain forward, ``Sd`` decode steps against the
    all-plain decode by steps (both the LLM gate), the prefill cache of an
    ``Sd``-token forward against the state the decode steps left; each
    block against its plain version on the same input (lockstep, reported
    beside the whole model's difference: its amplification); a forward's
    and 8 decode steps' device time; where ``batched``, the
    ``BATCH_SHAPES`` mix through a graphed ``BatchedServer`` against the
    plain versions' graphed run (``report_batched``, the finished gate,
    the launch gates) and gate (a), graph against eager; where
    ``f32_depth``, the model in f32 at that depth (a cut) against the
    all-plain f32 forward (``PATH_TOL``). Each check and launch count goes
    to ``gates``, labels led by ``pre``."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.models import transformer as T

    params = draw_model(cfg, dev)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(1, S))).to(dev)
    batch = {"tokens": toks}
    logits, counts = counted(gates, f"{pre}forward (1, {S})",
                             lambda: T.forward(params, batch, cfg)[0])
    gate_forward(gates, cfg, f"{pre}forward", counts)
    with plain_kernels():
        ref = T.forward(params, batch, cfg)[0]
    whole = rel_err(logits, ref)
    gates.logits(f"{pre}forward (1, {S}) vs all-plain", logits, ref)
    del logits, ref
    # each block in lockstep: its input the kernels' previous block's output
    x = params["embed"][toks]
    positions = torch.arange(S, dtype=torch.int32, device=dev)[None]
    worst = (0.0, -1)
    for i in range(cfg.num_layers):
        window = (None if cfg.local_global_pattern and i % 2 == 1
                  else cfg.sliding_window)
        bp = T._layer(params["blocks"], i)
        x, err = held(lambda: T._attn_block_seq(bp, x, cfg, positions,
                                                window)[0])
        worst = max(worst, (err, i))
    print(f"  {pre}blocks in lockstep, each against its plain version on the "
          f"same input: worst {worst[0]:.3e} (layer {worst[1]}, tol "
          f"{KERNEL_TOL['bfloat16']}); the whole model's logits "
          f"max|d|/max|ref| {whole:.3e}, {whole / max(worst[0], 1e-30):.1f}"
          f"-fold (reported)")
    del x

    (dec, dstate), counts = counted(
        gates, f"{pre}decode, {Sd} steps B=1",
        lambda: decode_by_steps(params, cfg, dev, "tokens", toks, Sd, True))
    gate_decode(gates, cfg, f"{pre}decode", counts, Sd)
    with plain_kernels():
        want = decode_by_steps(params, cfg, dev, "tokens", toks, Sd)
    gates.logits(f"{pre}decode, {Sd} steps, vs all-plain decode", dec, want)
    fl = T.forward(params, {"tokens": toks[:, :Sd]}, cfg)[0]
    cache_gates(gates, f"{pre}prefill cache, forward (1, {Sd})", cfg, params,
                {"tokens": toks[:, :Sd]}, fl, dstate, Sd)
    del dec, want, dstate, fl

    profile_steps(f"{pre}forward (1, {S})", lambda i: T.forward(
        params, batch, cfg), 1, extra=("fa_bf16",))
    state = T.init_decode_state(cfg, 1, 64, device=dev)
    for t in range(4):  # warm
        T.decode_step(params, state, {"tokens": toks[:, t:t + 1]}, t, cfg)
    profile_steps(f"{pre}8 decode steps B=1", lambda i: T.decode_step(
        params, state, {"tokens": toks[:, 4 + i:5 + i]}, 4 + i, cfg), 8,
        extra=("decode_",))
    if batched:
        got, steps, dt, counts, picks = batched_run(params, cfg, dev,
                                                    plain=False)
        gates.add(counts)
        want, _, dt_p, _, picks_p = batched_run(params, cfg, dev, plain=True)
        gates.check(report_batched(got, want, steps, dt, dt_p, picks,
                                   picks_p),
                    f"{pre}a batched request did not finish with its token "
                    f"count")
        gate_decode(gates, cfg, f"{pre}batched", counts, steps)
        graph_against_eager(gates, params, cfg, dev,
                            pre.strip() or cfg.name)
    del params, state
    torch.cuda.empty_cache()
    if not f32_depth:
        return
    c32 = dataclasses.replace(cfg, dtype="float32", num_layers=f32_depth)
    p32 = draw_model(c32, dev)
    logits, counts = counted(
        gates, f"{pre}f32 forward (1, {S}), layers={f32_depth} (a cut)",
        lambda: T.forward(p32, batch, c32)[0])
    gate_forward(gates, c32, f"{pre}f32 forward", counts)
    with plain_kernels():
        ref = T.forward(p32, batch, c32)[0]
    gates.relative(f"{pre}f32 forward (1, {S}) vs all-plain", logits, ref)
    del p32, logits, ref
    torch.cuda.empty_cache()


def archs_path(dev) -> dict:
    """The four archs no other path runs (``ARCHS_RUN``), each at its full
    published width in bf16 (the configs' dtype), its depth cut for the
    run's time, random weights from seed 0 drawn on the card.
    qwen3-moe-30b-a3b (128 experts, top-8, ``qk_norm``, 32/4 heads of 128
    on d_model 2048) through ``moe_model``'s gates without the batched
    server, its f32 arm at 2 layers; mistral-nemo-12b (query width 4096 on
    d_model 5120, untied head over 131072), gemma2-27b (two local/global
    pairs, window 4096, softcaps 50 and 30, tied head over 256000; its
    4608-token prompt runs past the window) and qwen3-32b (``qk_norm``,
    64/8 heads of 128 on 5120, untied head over 151936; its f32 arm at 2
    layers) through ``dense_model``'s. Returns the launch counts of the
    kernels' runs, each zeroed just before it; launch gates are checked
    last, so a CPU rehearsal runs every part."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config

    gates = PathGates("archs path")
    for name, depth, S, Sd, f32_depth in ARCHS_RUN:
        t0 = time.perf_counter()
        full = get_config(name)
        cfg = dataclasses.replace(full, num_layers=depth)
        feats = [f"{'tied' if cfg.tie_embeddings else 'untied'} head over "
                 f"{cfg.vocab_size}"]
        if cfg.is_moe:
            feats.insert(0, f"{cfg.num_experts} experts of d_ff {cfg.d_ff}, "
                            f"top-{cfg.top_k}")
        else:
            feats.insert(0, f"d_ff {cfg.d_ff}")
        if cfg.qk_norm:
            feats.append("qk_norm")
        if cfg.local_global_pattern:
            feats.append(f"local/global pairs, window {cfg.sliding_window}")
        if cfg.attn_softcap:
            feats.append(f"softcaps {cfg.attn_softcap:g}/"
                         f"{cfg.final_softcap:g}")
        print(f"archs path: {name} full width (d_model {cfg.d_model}, "
              f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}: "
              f"query width {cfg.num_heads * cfg.head_dim}, "
              + ", ".join(feats) + f"), layers={depth} (of "
              f"{full.num_layers}, a cut), {cfg.dtype}: forward (1, {S}), "
              f"{Sd} decode steps"
              + (f", f32 at {f32_depth} layers" if f32_depth else ""))
        if cfg.is_moe:
            moe_model(gates, cfg, dev, full.num_layers, f32_depth,
                      batched=True, pre=f"{name} ", S=S, Sd=Sd)
        else:
            dense_model(gates, cfg, dev, S, Sd, f32_depth, pre=f"{name} ",
                        batched=True)
        torch.cuda.empty_cache()
        print(f"  [{name}: {time.perf_counter() - t0:.1f} s]")
    print(f"  archs path launches (forwards + decode steps + f32 forwards): "
          f"{json.dumps({k: n for k, n in gates.main.items() if n})}")
    gates.finish()
    return {k: gates.main.get(k, 0) for k in (
        "flash_attention", "decode_attention", "matmul", "matmul_bf16",
        "gmm_blocks")}


@contextlib.contextmanager
def plain_counted(calls: dict):
    """The plain versions of the training paths' kernels, counted in
    ``calls`` where a wrapper would call them (on CPU tensors only)."""
    from repro_torch.kernels import attention as KA
    from repro_torch.kernels import gmm as KG
    from repro_torch.kernels import matmul as KM
    from repro_torch.kernels import ssd as KS

    # ssd_scan's CPU branch runs the plain phases from ssd_cum_cb on
    saved = [(KA, "flash_attention_plain"),
             (KA, "flash_attention_bwd_plain"), (KM, "matmul_plain"),
             (KG, "gmm_blocks_plain"), (KG, "gmm_blocks_dw_plain"),
             (KS, "ssd_cum_cb"), (KS, "ssd_scan_bwd_plain")]
    fns = [getattr(m, name) for m, name in saved]
    for (m, name), fn in zip(saved, fns):
        def wrapped(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        setattr(m, name, wrapped)
    try:
        yield
    finally:
        for (m, name), fn in zip(saved, fns):
            setattr(m, name, fn)


def trainable(cfg, dev):
    """``cfg``'s random weights from seed 0 on ``dev``, requiring grad."""
    from repro_torch import pytree

    params = draw_model(cfg, dev)
    for p in pytree.leaves(params):
        p.requires_grad_(True)
    return params


def held_step_grads(gates, cfg, params, batch, label, calls, gate_step):
    """One step's (gradients, metrics) with the kernels (counted, gated by
    ``gate_step``, the plain calls counted in ``calls``, an MoE model's
    routing recorded) and with the plain versions (torch autograd through
    them) under that routing; returns (gradients, metrics, the loss's
    relative difference, (the worst leaf's max|d|/max|ref|, its key),
    all finite), each leaf's error printed."""
    import torch

    from repro_torch import pytree
    from repro_torch.train import step_grads

    with plain_counted(calls), routing_log() as log:
        (g, m), counts = counted(gates, label, lambda: step_grads(
            params, batch, cfg, num_microbatches=TRAIN_MICRO, remat=False))
    gate_step(cfg, label, counts, False)
    with plain_kernels(), routing_log(replay=log):
        gp, mp = step_grads(params, batch, cfg, num_microbatches=TRAIN_MICRO,
                            remat=False)
    keys = [k for k, _ in pytree.flatten_with_path(params)]
    rels = [(rel_err(a, b), k) for a, b, k in zip(g, gp, keys)]
    worst = max(rels)
    lrel = abs(m["loss"].item() - mp["loss"].item()) / abs(
        mp["loss"].item())
    aux = m["aux_loss"].item()
    finite = all(bool(torch.isfinite(a).all()) for a in g)
    print(f"  {label} vs plain" + (" (routing replayed)" if log else "")
          + f": loss {m['loss'].item():.6f} vs {mp['loss'].item():.6f} "
          f"(rel {lrel:.3e})"
          + (f", aux {aux:.6f} vs {mp['aux_loss'].item():.6f}" if aux
             else "")
          + f"; worst of {len(keys)} gradient leaves {worst[1]} "
          f"max|d|/max|ref| {worst[0]:.3e} ("
          + ", ".join(f"{k.split(chr(39))[-2]} {e:.2e}" for e, k in rels)
          + f"); finite {finite}")
    return g, m, lrel, worst, finite


def lockstep_block_grads(params, cfg, batch, dev):
    """Each block of ``params`` (an attention block; a mamba block; the
    hybrid's shared block at each group's end) on the kernels' hidden
    state of ``batch``'s first microbatch, its gradients (weights and
    input) under one cotangent of its output (and 0.01 of its aux loss, an
    MoE block's routing replayed), against its plain version's: (the
    worst max|d|/max|ref|, its block, its leaf)."""
    import numpy as np
    import torch

    from repro_torch import pytree
    from repro_torch.models import transformer as T

    mb = {k: v[0] for k, v in batch.items()}
    with torch.no_grad():
        x, _ = T._embed_input(params, cfg, mb)
    positions = torch.arange(x.shape[1], dtype=torch.int32,
                             device=dev).expand(x.shape[0], -1)
    dy = torch.from_numpy(np.random.default_rng(5).standard_normal(
        tuple(x.shape)).astype(np.float32)).to(dev, x.dtype)
    daux = torch.tensor(0.01, device=dev)

    def attn(bp, xi):
        return T._attn_block_seq(bp, xi, cfg, positions, cfg.sliding_window)

    def mamba(bp, xi):
        return T._mamba_block_seq(bp, xi, cfg)[0], None

    blocks = T._unbind(params["blocks"], cfg.num_layers)
    if cfg.family not in ("ssm", "hybrid"):
        units = [(i, blk, attn) for i, blk in enumerate(blocks)]
    else:
        units = []
        for i, blk in enumerate(blocks):
            units.append((i, blk, mamba))
            if cfg.family == "hybrid" and (i + 1) % cfg.shared_attn_every == 0:
                units.append((f"shared after {i}", params["shared"], attn))
    lock = (0.0, -1, "")
    for at, blk, fn in units:
        bp = pytree.tree_map(lambda t: t.detach().requires_grad_(), blk)
        xi = x.detach().requires_grad_()
        ins = [xi] + pytree.leaves(bp)
        names = ["x"] + [k for k, _ in pytree.flatten_with_path(bp)]

        def block():
            out, aux = fn(bp, xi)
            if aux is None:
                return out, torch.autograd.grad(out, ins, dy)
            return out, torch.autograd.grad([out, aux], ins, [dy, daux])

        with routing_log() as log:
            out, gk = block()
        with plain_kernels(), routing_log(replay=log):
            _, gp = block()
        lock = max([lock] + [(rel_err(a, b), at, nm)
                             for a, b, nm in zip(gk, gp, names)],
                   key=lambda t: t[0])
        x = out.detach()
    return lock


def train_steps_held(gates, cfg, params, batch, curve, calls, gate_step,
                     card, extra, lr=3e-3, fall=1.0):
    """``make_train_step`` (remat, peak ``lr``, warmup 5) on ``batch``: two
    steps from copies of one state must give bitwise-equal params and
    moments; the loss over ``curve`` steps must end below ``fall`` times
    its first; ms a step, tokens/s,
    and two steps' device busy and idle (``profile_steps``, the kernels
    named by ``extra``)."""
    import numpy as np
    import torch

    from repro_torch import pytree
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_train_step

    L, n, tokens = cfg.num_layers, TRAIN_MICRO, TRAIN_BATCH * TRAIN_SEQ
    step = make_train_step(cfg, lr=lr, warmup=5, total_steps=curve,
                           num_microbatches=n, remat=True)
    opt = adamw_init(params)
    p2, o2 = pytree.tree_map(lambda t: t.detach().clone(), (params, opt))
    label = f"{cfg.dtype} train step (remat)"
    with plain_counted(calls):
        (params, opt, m0), counts = counted(
            gates, label, lambda: step(params, opt, batch))
    gate_step(cfg, label, counts, True)
    p2, o2, _ = step(p2, o2, batch)
    same = all(torch.equal(a, b) for a, b in zip(
        pytree.leaves((params, opt)), pytree.leaves((p2, o2))))
    print(f"  two {cfg.dtype} steps from copies of one state: params and "
          f"moments bitwise equal: {same}")
    gates.check(same, "two train steps from one state differ")
    del p2, o2
    torch.cuda.empty_cache()
    # the loss curve on batch: the step above is its first
    losses = [m0["loss"].item()]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with plain_counted(calls):
        for _ in range(curve - 1):
            params, opt, mi = step(params, opt, batch)
            losses.append(mi["loss"])
    losses = losses[:1] + [t.item() for t in losses[1:]]
    dt = time.perf_counter() - t0
    print(f"  loss over {curve} steps on batch_at(0) (lr {lr:g}, warmup 5): "
          + " ".join(f"{x:.4f}" for x in losses))
    print(f"  {cfg.dtype} train step, {L} layers, {tokens} tokens in {n} "
          f"microbatches, remat: {dt * 1e3 / (curve - 1):.1f} ms/step "
          f"wall, {tokens * (curve - 1) / dt:,.0f} tokens/s ({card})")
    gates.check(all(np.isfinite(losses)) and losses[-1] < fall * losses[0],
                f"the loss does not fall below {fall:g} of its first over "
                f"{curve} steps: {losses[0]:.4f} -> {losses[-1]:.4f}")
    state = [params, opt]

    def one_step(i):
        state[0], state[1], _ = step(state[0], state[1], batch)

    with plain_counted(calls):
        profile_steps(f"{cfg.dtype} {cfg.name} train step ({L} layers, {n} "
                      f"microbatches, remat)", one_step, 2, extra=extra)
    del params, opt, state
    torch.cuda.empty_cache()


def training_path(dev, card: str, f32_depth: int) -> dict:
    """Dense-body training at smollm-360m's full width (d_model 960, 15/5
    heads of 64, d_ff 2560, tied vocab 49152) on ``SyntheticPipeline(cfg,
    TRAIN_BATCH, TRAIN_SEQ, microbatches=TRAIN_MICRO, seed=0)``, weights
    drawn on the card from seed 0. In f32 at ``f32_depth`` layers (a cut
    of depth): one step's loss and every f32 gradient leaf (``step_grads``,
    microbatches summed) with the kernels against the same with
    ``plain_kernels()`` (torch autograd through the plain versions): loss
    within 1e-5 relative, each leaf within ``PATH_TOL`` of its max|ref|;
    ``remat=True`` gives bitwise the same loss and gradients; one
    ``make_train_step`` step, then ``save_pytree`` of params and AdamW
    state and ``load_pytree`` give back bitwise-equal tensors. In bf16 at
    all 32 layers: the loss within 1e-2 relative of plain's, each
    gradient leaf's max|d|/max|ref| reported and gated at
    ``TRAIN_BF16_TOL`` (where the whole model amplifies rounding past it,
    each block's gradients, of its weights and its input, held to its
    plain version's on the same input and output gradient instead, and
    said); two ``make_train_step`` steps (remat on, lr 3e-3, warmup 5)
    from copies of one state give bitwise-equal params and moments; the
    loss over ``TRAIN_CURVE`` steps on ``batch_at(0)`` must fall; tokens/s
    and a step's device busy and idle (``torch.profiler``). Launch gates a
    step: ``flash_attention_bwd`` L x microbatches, ``flash_attention`` L
    x microbatches (twice with remat), the matmul 3 x (7L + 1) x
    microbatches (4 x 7L + 3 a microbatch with remat), and no plain
    version called on the kernel path. Returns the launch counts of the
    kernels' runs, each zeroed just before it; gates are checked last."""
    import dataclasses

    import torch

    from repro_torch import pytree
    from repro_torch.checkpoint import load_pytree, save_pytree
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticPipeline
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_train_step, step_grads

    gates = PathGates("training path")
    n = TRAIN_MICRO
    base = get_config("smollm-360m")
    print(f"training path: {base.name} full width (d_model {base.d_model}, "
          f"{base.num_heads}/{base.num_kv_heads} heads of {base.head_dim}, "
          f"d_ff {base.d_ff}, tied vocab {base.vocab_size}), "
          f"SyntheticPipeline(batch {TRAIN_BATCH}, seq {TRAIN_SEQ}, "
          f"microbatches {n}, seed 0): {TRAIN_BATCH * TRAIN_SEQ} tokens a "
          f"step; f32 at {f32_depth} of {base.num_layers} layers (a cut of "
          f"depth), bf16 at all {base.num_layers}")
    plain_calls = {}

    def gate_step(cfg, label, counts, remat):
        L, mm = cfg.num_layers, ("matmul" if cfg.dtype == "float32"
                                 else "matmul_bf16")
        gates.launched(label, "flash_attention_bwd",
                       counts["flash_attention_bwd"], L * n)
        gates.launched(label, "flash_attention", counts["flash_attention"],
                       L * n * (2 if remat else 1))
        gates.launched(label, mm, counts[mm],
                       (4 * 7 * L + 3) * n if remat else 3 * (7 * L + 1) * n)

    # -- f32 at f32_depth layers: the f32 gate, remat, a checkpoint -------
    cfg = dataclasses.replace(base, num_layers=f32_depth, dtype="float32")
    params = trainable(cfg, dev)
    batch = SyntheticPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, microbatches=n,
                              seed=0, device=dev).batch_at(0)
    g, m, lrel, worst, finite = held_step_grads(
        gates, cfg, params, batch, f"f32 {f32_depth}-layer step gradients",
        plain_calls, gate_step)
    gates.check(finite and lrel <= 1e-5 and worst[0] <= PATH_TOL,
                f"f32 step: loss rel {lrel:.3e} (gate 1e-5) or leaf "
                f"{worst[1]} {worst[0]:.3e} (gate {PATH_TOL}) leaves the "
                f"gate")
    label = f"f32 {f32_depth}-layer step gradients, remat"
    with plain_counted(plain_calls):
        (gr, mr), counts = counted(gates, label, lambda: step_grads(
            params, batch, cfg, num_microbatches=n, remat=True))
    gate_step(cfg, label, counts, True)
    same = torch.equal(m["loss"], mr["loss"]) and all(
        torch.equal(a, b) for a, b in zip(g, gr))
    print(f"  remat=True vs remat=False: loss and {len(g)} gradient leaves "
          f"bitwise equal: {same}")
    gates.check(same, "remat changes the f32 gradients' bits")
    del g, gr
    step = make_train_step(cfg, num_microbatches=n, remat=False)
    params, opt, _ = step(params, adamw_init(params), batch)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        save_pytree(d, (params, opt))
        back = load_pytree(d, (params, opt))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    src, got = pytree.leaves((params, opt)), pytree.leaves(back)
    same = len(src) == len(got) and all(
        a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
        for a, b in zip(src, got))
    print(f"  checkpoint: save_pytree + load_pytree of params and AdamW "
          f"state ({len(src)} leaves, "
          f"{sum(t.numel() * 4 for t in src) / 1e9:.2f} GB as f32 .npy) in "
          f"{dt:.2f} s: bitwise equal {same}")
    gates.check(same, "checkpoint round trip is not bitwise equal")
    del params, opt, back, src, got, batch
    torch.cuda.empty_cache()

    # -- bf16 at all layers -----------------------------------------------
    cfg = base
    params = trainable(cfg, dev)
    batch = SyntheticPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, microbatches=n,
                              seed=0, device=dev).batch_at(0)
    g, m, lrel, worst, finite = held_step_grads(
        gates, cfg, params, batch, f"bf16 {cfg.num_layers}-layer step "
        f"gradients", plain_calls, gate_step)
    del g
    gates.check(finite and lrel <= 1e-2,
                f"bf16 step: loss rel {lrel:.3e} leaves the gate 1e-2")
    bf16_grads_gated(gates, params, cfg, batch, dev, worst)
    train_steps_held(gates, cfg, params, batch, TRAIN_CURVE, plain_calls,
                     gate_step, card, ("fab_", "fa_bf16", "gemm_",
                                       "elementwise", "reduce"))
    del params, batch
    torch.cuda.empty_cache()
    print(f"  training path launches: "
          f"{json.dumps({k: c for k, c in gates.main.items() if c})}")
    gates.check(not plain_calls, f"plain versions called on the kernel "
                                 f"path: {plain_calls}")
    gates.finish()
    return {k: gates.main[k] for k in ("flash_attention_bwd",
                                       "flash_attention", "matmul",
                                       "matmul_bf16")}


def bf16_grads_gated(gates, params, cfg, batch, dev, worst) -> None:
    """The bf16 gradient gate: the whole model's worst leaf ``worst``
    within ``TRAIN_BF16_TOL``, or else each block in lockstep
    (``lockstep_block_grads``, run either way and printed with the
    model's amplification of its worst block)."""
    lock = lockstep_block_grads(params, cfg, batch, dev)
    whole = worst[0] <= TRAIN_BF16_TOL
    print(f"  bf16 blocks in lockstep (each block's gradients of its "
          f"weights and input under one output cotangent, on the kernels' "
          f"hidden state): worst {lock[0]:.3e} (block {lock[1]}, "
          f"{lock[2]}); the whole model's worst leaf {worst[0]:.3e} "
          f"({worst[0] / max(lock[0], 1e-30):.1f}x); gate "
          f"{TRAIN_BF16_TOL} held by "
          + ("the whole model's leaves" if whole else
             "the blocks in lockstep: the whole model amplifies rounding "
             "past it"))
    gates.check(whole or lock[0] <= TRAIN_BF16_TOL,
                f"bf16 gradients leave the gate: whole model {worst[1]} "
                f"{worst[0]:.3e}, lockstep block {lock[1]} {lock[2]} "
                f"{lock[0]:.3e}")


def moe_training_path(dev, card: str, f32_depth: int, depth: int) -> dict:
    """MoE training at granite-moe-3b-a800m's full width (d_model 1536,
    24/8 heads of 64, 40 experts of d_ff 512, top-8, tied vocab 49155) on
    ``SyntheticPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, microbatches=
    TRAIN_MICRO, seed=0)`` (2048 tokens a microbatch: expert blocks of C
    ``MOE_TRAIN_C``), weights drawn on the card from seed 0. In f32 at
    ``f32_depth`` layers (a cut of depth): one step's loss and every f32
    gradient leaf (router, experts, attention, norms, embed) with the
    kernels against torch autograd through the plain versions
    (``plain_kernels()``: the grouped FFN's plain forward differentiated
    by autograd) under the kernel run's routing replayed (the replayed
    top-k weights keep their gradient through the router's
    probabilities): loss within 1e-5 relative, each leaf within
    ``PATH_TOL`` of its max|ref|; ``remat=True`` gives bitwise the same
    loss, aux loss and gradients (the recomputed forward routes as the
    first). In bf16 at ``depth`` layers: the loss within 1e-2 of plain's,
    each leaf within ``TRAIN_BF16_TOL`` under the replayed routing, or,
    where the model amplifies rounding past it, each block in lockstep
    (its output and 0.01 of its aux loss under one cotangent, its routing
    replayed; run and printed either way, with the amplification); two
    ``make_train_step`` steps from copies of one state bitwise equal; the
    loss falling over ``MOE_TRAIN_CURVE`` steps on ``batch_at(0)``; ms a
    step, tokens/s and a step's device busy and idle. Launch gates a
    microbatch: a layer's ``gmm_blocks`` 8 times (3 forward, 5 backward:
    g and u recomputed, dh and dblk's two products with w read K-major in
    place), 11 with remat, ``gmm_blocks_dw`` 3 times (in bf16 every one
    on its TMA path, ``gemm_path_counts``' "tma"),
    ``flash_attention_bwd`` once, ``flash_attention`` once (twice with
    remat); the f32 ``matmul`` the router's 3 a layer (4 with remat) and,
    in f32, the attention's 12 (16) and the tied head's 3, in bf16 those
    on ``matmul_bf16``; and no plain version called on the kernel path.
    Returns the launch counts of the kernels' runs, each zeroed just
    before it; gates are checked last."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticPipeline
    from repro_torch.kernels import ops
    from repro_torch.models import moe as MOE
    from repro_torch.train import step_grads

    gates = PathGates("moe training path")
    n = TRAIN_MICRO
    base = get_config("granite-moe-3b-a800m")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    C = MOE.capacity(tokens // n, base)
    print(f"moe training path: {base.name} full width (d_model "
          f"{base.d_model}, {base.num_heads}/{base.num_kv_heads} heads of "
          f"{base.head_dim}, {base.num_experts} experts of d_ff "
          f"{base.d_ff}, top-{base.top_k}, vocab {base.vocab_size}), "
          f"SyntheticPipeline(batch {TRAIN_BATCH}, seq {TRAIN_SEQ}, "
          f"microbatches {n}, seed 0): {tokens} tokens a step, expert "
          f"blocks of C {C}; f32 at {f32_depth} and bf16 at {depth} of "
          f"{base.num_layers} layers (cuts of depth)")
    gates.check(C == MOE_TRAIN_C, f"capacity {C}, not {MOE_TRAIN_C}")
    plain_calls = {}

    def gate_step(cfg, label, counts, remat):
        L, r = cfg.num_layers, int(remat)
        gates.launched(label, "gmm_blocks", counts["gmm_blocks"],
                       (8 + 3 * r) * L * n)
        gates.launched(label, "gmm_blocks_dw", counts["gmm_blocks_dw"],
                       3 * L * n)
        if cfg.dtype != "float32":
            # every bf16 dw on the TMA + wgmma kernel (the counts of the
            # run just read, zeroed with the launch counts)
            paths = ops.gemm_path_counts()
            print(f"  {label}: bf16 GEMM launches by path "
                  f"{json.dumps(paths)}")
            gates.check(paths["tma"] == counts["gmm_blocks_dw"],
                        f"{label}: {paths['tma']} of "
                        f"{counts['gmm_blocks_dw']} gmm_blocks_dw launches "
                        f"on the tma path")
        gates.launched(label, "flash_attention_bwd",
                       counts["flash_attention_bwd"], L * n)
        gates.launched(label, "flash_attention", counts["flash_attention"],
                       (1 + r) * L * n)
        proj = (12 + 4 * r) * L + 3     # attention's four, the tied head
        router = (3 + r) * L
        if cfg.dtype == "float32":
            gates.launched(label, "matmul", counts["matmul"],
                           (proj + router) * n)
        else:
            gates.launched(label, "matmul", counts["matmul"], router * n)
            gates.launched(label, "matmul_bf16", counts["matmul_bf16"],
                           proj * n)

    # -- f32 at f32_depth layers: the f32 gate under one routing, remat ---
    cfg = dataclasses.replace(base, num_layers=f32_depth, dtype="float32")
    params = trainable(cfg, dev)
    batch = SyntheticPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, microbatches=n,
                              seed=0, device=dev).batch_at(0)
    g, m, lrel, worst, finite = held_step_grads(
        gates, cfg, params, batch, f"f32 {f32_depth}-layer step gradients",
        plain_calls, gate_step)
    gates.check(finite and lrel <= 1e-5 and worst[0] <= PATH_TOL,
                f"f32 step: loss rel {lrel:.3e} (gate 1e-5) or leaf "
                f"{worst[1]} {worst[0]:.3e} (gate {PATH_TOL}) leaves the "
                f"gate")
    label = f"f32 {f32_depth}-layer step gradients, remat"
    with plain_counted(plain_calls):
        (gr, mr), counts = counted(gates, label, lambda: step_grads(
            params, batch, cfg, num_microbatches=n, remat=True))
    gate_step(cfg, label, counts, True)
    same = all(torch.equal(m[k], mr[k]) for k in ("loss", "aux_loss")) \
        and all(torch.equal(a, b) for a, b in zip(g, gr))
    print(f"  remat=True vs remat=False: loss, aux and {len(g)} gradient "
          f"leaves bitwise equal: {same}")
    gates.check(same, "remat changes the f32 loss or gradients' bits")
    del g, gr, params, batch
    torch.cuda.empty_cache()

    # -- bf16 at depth layers -----------------------------------------------
    cfg = dataclasses.replace(base, num_layers=depth)
    params = trainable(cfg, dev)
    batch = SyntheticPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ, microbatches=n,
                              seed=0, device=dev).batch_at(0)
    g, m, lrel, worst, finite = held_step_grads(
        gates, cfg, params, batch, f"bf16 {depth}-layer step gradients",
        plain_calls, gate_step)
    del g
    gates.check(finite and lrel <= 1e-2,
                f"bf16 step: loss rel {lrel:.3e} leaves the gate 1e-2")
    bf16_grads_gated(gates, params, cfg, batch, dev, worst)
    train_steps_held(gates, cfg, params, batch, MOE_TRAIN_CURVE,
                     plain_calls, gate_step, card,
                     ("gemm_", "fab_", "fa_bf16", "elementwise", "reduce",
                      "index"))
    del params, batch
    torch.cuda.empty_cache()
    print(f"  moe training path launches: "
          f"{json.dumps({k: c for k, c in gates.main.items() if c})}")
    gates.check(not plain_calls, f"plain versions called on the kernel "
                                 f"path: {plain_calls}")
    gates.finish()
    return {k: gates.main[k] for k in ("gmm_blocks", "gmm_blocks_dw",
                                       "flash_attention_bwd",
                                       "flash_attention", "matmul",
                                       "matmul_bf16")}


def ssm_training_path(dev, card: str) -> dict:
    """SSM and hybrid training at full width on ``SyntheticPipeline(cfg,
    TRAIN_BATCH, TRAIN_SEQ, microbatches=TRAIN_MICRO, seed=0)`` (2048
    tokens a microbatch: two 256-token chunks, so the backward carries a
    state gradient across chunks), weights drawn on the card from seed 0:
    mamba2-2.7b (d_model 2560, 80 SSM heads of P 64, N 128) and zamba2-2.7b
    (N 64, the shared attention block of 32/32 heads of 80 after every 6
    mamba blocks). Each arch in f32 at a cut of depth
    (``SSM_TRAIN_F32_DEPTH``, ``HYBRID_TRAIN_F32_DEPTH``): one step's loss
    and every gradient leaf with the kernels against torch autograd through
    the plain versions (``plain_kernels()``: ``ssd_scan_plain``, whose
    exponent is masked before exp), loss within 1e-5 relative, each leaf
    within ``PATH_TOL`` of its max|ref|, and ``remat=True`` (a mamba block
    a checkpoint; a group and its shared block for hybrid) bitwise equal;
    in bf16 at ``SSM_TRAIN_DEPTH`` and ``HYBRID_TRAIN_DEPTH``: the loss
    within 1e-2 of plain's, each leaf within ``TRAIN_BF16_TOL`` or, where
    the model amplifies rounding past it, each block in lockstep (mamba
    blocks and each application of the shared block; run and printed
    either way, with the amplification); two ``make_train_step`` steps from
    copies of one state bitwise equal; the loss falling over
    ``SSM_TRAIN_CURVE`` steps on ``batch_at(0)`` (the hybrid's at peak lr
    ``HYBRID_TRAIN_LR``, to below ``HYBRID_TRAIN_FALL`` of its first); ms a
    step, tokens/s and a
    step's device busy and idle. Launch gates a microbatch: ``ssd_scan``
    once a mamba layer (twice with remat), ``ssd_scan_bwd`` once;
    ``flash_attention`` once a shared-block application (twice with
    remat), ``flash_attention_bwd`` once; the matmul 3 x F (4 x F - 1 with
    remat), F = 6 a mamba layer + 7 a shared application + 1 (the tied
    head), on ``matmul`` in f32 and ``matmul_bf16`` in bf16; and no plain
    version called on the kernel path. Returns the launch counts of the
    kernels' runs, each zeroed just before it; gates are checked last."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticPipeline
    from repro_torch.train import step_grads

    gates = PathGates("ssm training path")
    n = TRAIN_MICRO
    plain_calls = {}

    def gate_step(cfg, label, counts, remat):
        L, r = cfg.num_layers, int(remat)
        G = L // cfg.shared_attn_every if cfg.family == "hybrid" else 0
        gates.launched(label, "ssd_scan", counts["ssd_scan"], (1 + r) * L * n)
        gates.launched(label, "ssd_scan_bwd", counts["ssd_scan_bwd"], L * n)
        if G:
            gates.launched(label, "flash_attention",
                           counts["flash_attention"], (1 + r) * G * n)
            gates.launched(label, "flash_attention_bwd",
                           counts["flash_attention_bwd"], G * n)
        F = 6 * L + 7 * G + 1
        mm = "matmul" if cfg.dtype == "float32" else "matmul_bf16"
        gates.launched(label, mm, counts[mm], (4 * F - 1 if remat else 3 * F)
                       * n)

    for arch, f32_depth, depth, lr, fall in (
            ("mamba2-2.7b", SSM_TRAIN_F32_DEPTH, SSM_TRAIN_DEPTH, 3e-3, 1.0),
            ("zamba2-2.7b", HYBRID_TRAIN_F32_DEPTH, HYBRID_TRAIN_DEPTH,
             HYBRID_TRAIN_LR, HYBRID_TRAIN_FALL)):
        base = get_config(arch)
        print(f"ssm training path: {base.name} full width (d_model "
              f"{base.d_model}, {base.ssm_heads} SSM heads of P "
              f"{base.ssm_head_dim}, N {base.ssm_state}, chunk "
              f"{base.ssm_chunk}"
              + (f", the shared block of {base.num_heads}/"
                 f"{base.num_kv_heads} heads of {base.head_dim} after every "
                 f"{base.shared_attn_every} mamba blocks"
                 if base.family == "hybrid" else "")
              + f", tied vocab {base.vocab_size}), SyntheticPipeline(batch "
              f"{TRAIN_BATCH}, seq {TRAIN_SEQ}, microbatches {n}, seed 0): "
              f"{TRAIN_BATCH * TRAIN_SEQ} tokens a step; f32 at {f32_depth} "
              f"and bf16 at {depth} of {base.num_layers} layers (cuts of "
              f"depth)")
        # -- f32: the f32 gate, remat ---------------------------------------
        cfg = dataclasses.replace(base, num_layers=f32_depth,
                                  dtype="float32")
        params = trainable(cfg, dev)
        batch = SyntheticPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                  microbatches=n, seed=0,
                                  device=dev).batch_at(0)
        g, m, lrel, worst, finite = held_step_grads(
            gates, cfg, params, batch,
            f"{arch} f32 {f32_depth}-layer step gradients", plain_calls,
            gate_step)
        gates.check(finite and lrel <= 1e-5 and worst[0] <= PATH_TOL,
                    f"{arch} f32 step: loss rel {lrel:.3e} (gate 1e-5) or "
                    f"leaf {worst[1]} {worst[0]:.3e} (gate {PATH_TOL}) "
                    f"leaves the gate")
        label = f"{arch} f32 {f32_depth}-layer step gradients, remat"
        with plain_counted(plain_calls):
            (gr, mr), counts = counted(gates, label, lambda: step_grads(
                params, batch, cfg, num_microbatches=n, remat=True))
        gate_step(cfg, label, counts, True)
        same = torch.equal(m["loss"], mr["loss"]) and all(
            torch.equal(a, b) for a, b in zip(g, gr))
        print(f"  remat=True vs remat=False: loss and {len(g)} gradient "
              f"leaves bitwise equal: {same}")
        gates.check(same, f"{arch}: remat changes the f32 gradients' bits")
        del g, gr, params, batch
        torch.cuda.empty_cache()

        # -- bf16 -----------------------------------------------------------
        cfg = dataclasses.replace(base, num_layers=depth)
        params = trainable(cfg, dev)
        batch = SyntheticPipeline(cfg, TRAIN_BATCH, TRAIN_SEQ,
                                  microbatches=n, seed=0,
                                  device=dev).batch_at(0)
        g, m, lrel, worst, finite = held_step_grads(
            gates, cfg, params, batch,
            f"{arch} bf16 {depth}-layer step gradients", plain_calls,
            gate_step)
        del g
        gates.check(finite and lrel <= 1e-2,
                    f"{arch} bf16 step: loss rel {lrel:.3e} leaves the gate "
                    f"1e-2")
        bf16_grads_gated(gates, params, cfg, batch, dev, worst)
        train_steps_held(gates, cfg, params, batch, SSM_TRAIN_CURVE,
                         plain_calls, gate_step, card,
                         ("ssd_bwd", "ssd_", "gemm_", "fab_", "elementwise",
                          "reduce"), lr, fall)
        del params, batch
        torch.cuda.empty_cache()
    print(f"  ssm training path launches: "
          f"{json.dumps({k: c for k, c in gates.main.items() if c})}")
    gates.check(not plain_calls, f"plain versions called on the kernel "
                                 f"path: {plain_calls}")
    gates.finish()
    return {k: gates.main[k] for k in ("ssd_scan", "ssd_scan_bwd",
                                       "flash_attention",
                                       "flash_attention_bwd", "matmul",
                                       "matmul_bf16")}


# the hand-written kernel each CNN registry kernel launches, once a layer
# per forward (``direct`` convs run cuDNN, the reference's lax.conv)
def roofline_path(dev, card: str) -> dict:
    """The roofline report on the card: ``launch.dryrun.build_step``'s
    ``prefill_step`` (``forward(collect_cache=True)``, the last position's
    logits and the cache) on a (1, ``ROOFLINE_SEQ``) prompt at full width,
    random weights from seed 0 drawn on the card: smollm-360m at all 32
    layers and zamba2-2.7b at ``HYBRID_DEPTH`` (its bf16 ``matmul``,
    ``flash_attention`` and ``ssd_scan`` kernels). Each step is counted by
    ``roofline.op_cost`` on the card (the launch counts zeroed just
    before and read just after) and again on meta; the report prints
    flops, bytes, the compute and memory terms at the data-sheet rates,
    the bottleneck, ``useful_flops_ratio``, the count's peak live bytes
    beside ``torch.cuda.max_memory_allocated`` and the measured device
    busy time (``profile_steps``: ``torch.profiler``, after a warm run). Gates: the meta
    count equals the card count (flops, bytes, transcendentals, ops, the
    kernels' calls and costs); ``model_flops`` <= the counted flops;
    max(compute, memory) / device busy <= ``ROOFLINE_SHARE`` (a share
    over 1 means the count is wrong); each kernel of the step launched
    its expected times. Returns the launch counts of the counted runs."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as M
    from repro_torch.roofline.analysis import roofline_terms

    gates = PathGates("roofline path")
    sc = ShapeConfig(f"prefill_{ROOFLINE_SEQ}", ROOFLINE_SEQ, 1, "prefill")
    for arch, over in (("smollm-360m", None),
                       ("zamba2-2.7b", {"num_layers": HYBRID_DEPTH})):
        t_arch = time.perf_counter()
        step = dryrun.build_step(arch, sc, device=dev, cfg_overrides=over)
        cfg = step.cfg
        with torch.no_grad():
            step.fn(*step.args)  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        _, cost, arg_b, out_b, _ = dryrun.count_step(step)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        gates.add(counts)
        peak_alloc = torch.cuda.max_memory_allocated(dev)
        with torch.no_grad():
            busy = profile_steps(f"{arch} prefill_step (1, {ROOFLINE_SEQ})",
                                 lambda i: step.fn(*step.args), 3)
        del step
        torch.cuda.empty_cache()
        meta = dryrun.build_step(arch, sc, device="meta", cfg_overrides=over)
        _, mcost, *_ = dryrun.count_step(meta)
        r = roofline_terms(
            arch=arch, shape=sc.name, mesh_name="1x1", chips=1,
            flops=cost.flops, hbm_bytes=cost.hbm_bytes,
            model_flops=meta.model_flops, peak_flops=M.PEAK_FLOPS_BF16,
            hbm_bw=M.HBM_BW, peak_memory_bytes=cost.peak_bytes)
        roof_ms = max(r.compute_s, r.memory_s) * 1e3
        share = roof_ms / busy if busy else float("inf")
        same = (cost.totals() == mcost.totals() and cost.ops == mcost.ops
                and cost.kernels == mcost.kernels)
        print(f"  roofline, {arch} ({cfg.num_layers} layers, {cfg.dtype}) "
              f"prefill_step (1, {ROOFLINE_SEQ}) on {card}: flops="
              f"{cost.flops:.6e} bytes={cost.hbm_bytes:.6e} "
              f"transcendentals={cost.transcendentals:.6e} ops={cost.ops}; "
              f"compute_s={r.compute_s * 1e3:.4f} ms memory_s="
              f"{r.memory_s * 1e3:.4f} ms (data-sheet rates) bottleneck="
              f"{r.bottleneck} useful_flops_ratio={r.useful_flops_ratio:.4f}"
              f" (model_flops {r.model_flops:.6e}); peak live bytes "
              f"{cost.peak_bytes / 1e9:.4f} GB (args {arg_b / 1e9:.4f}, "
              f"outputs {out_b / 1e9:.4f}) beside max_memory_allocated "
              f"{peak_alloc / 1e9:.4f} GB; device busy "
              f"{busy if busy is None else round(busy, 4)} ms; roofline / "
              f"busy = {share:.4f} (gate "
              f"{ROOFLINE_SHARE}); meta count equal: {same}; kernels "
              + json.dumps({k: [int(v[0]), v[1], v[2]]
                            for k, v in sorted(cost.kernels.items())})
              + f"; top bytes {cost.top_hbm(4)}; "
              f"{time.perf_counter() - t_arch:.1f} s")
        gates.check(same, f"{arch}: the meta count {mcost.totals()} "
                    f"{mcost.ops} ops is not the card's {cost.totals()} "
                    f"{cost.ops} ops")
        gates.check(r.model_flops <= cost.flops,
                    f"{arch}: model_flops {r.model_flops:.4e} above the "
                    f"counted {cost.flops:.4e}")
        gates.check(busy is not None and share <= ROOFLINE_SHARE,
                    f"{arch}: roofline {roof_ms:.4f} ms over the device "
                    f"busy {busy} ms ({share:.4f} > {ROOFLINE_SHARE})")
        attn = (cfg.num_layers // cfg.shared_attn_every
                if cfg.family == "hybrid" else cfg.num_layers)
        gates.launched(arch, "flash_attention", counts["flash_attention"],
                       attn)
        gates.launched(arch, "matmul_bf16", counts["matmul_bf16"])
        if cfg.family == "hybrid":
            gates.launched(arch, "ssd_scan", counts["ssd_scan"],
                           cfg.num_layers)
        del meta
    gates.finish()
    return {k: gates.main[k] for k in ("matmul_bf16", "flash_attention",
                                       "ssd_scan")}


CNN_KERNELS = {("conv2d", "im2col_sgemm"): "matmul",
               ("conv2d", "winograd_f2x3"): "winograd_tile_matmul",
               ("linear", "direct"): "matmul",
               ("linear", "packed"): "matmul_packed"}


def cnn_kernels(layers, choices) -> dict:
    """The hand-written kernels a CNN plan's choices launch, with their
    launches per forward."""
    out = {}
    for l, c in zip(layers, choices):
        k = CNN_KERNELS.get((l.spec.op_type, c.kernel))
        if k is not None:
            out[k] = out.get(k, 0) + 1
    return out


def switching_path(card, eng, layers, x_np, decided, im2col_pin,
                   check_output) -> dict:
    """``ContinuousSession`` (paper §3.5) on resnet50@224: K_cold is the
    decided plan, or the pinned im2col plan where the decided plan already
    is K_warm on every weighted layer; ``cold_infer`` from a first read,
    then ``warm_infer(wait=True)`` twice against ``run_warm``. Returns the
    launch counts of the session's three inferences."""
    from repro_torch.core.switching import ContinuousSession
    from repro_torch.kernels import ops

    print(f"continuous mode: ContinuousSession on resnet50 image=224 "
          f"width=1.0 ({card})")
    warm = eng.warm_best_choices()
    weighted = [i for i, l in enumerate(layers) if l.spec.weight_shapes]
    if all(decided.choices[i].kernel == warm[i].kernel for i in weighted):
        eng.set_plan(replace(decided, choices=im2col_pin))
        label = "pinned im2col+direct (the decided plan is K_warm)"
    else:
        eng.set_plan(decided)
        label = "decided plan"
    plan = eng.plan
    moves = [layers[i].spec.name for i in weighted
             if plan.choices[i].kernel != warm[i].kernel]
    print(f"  K_cold: {label}; K_warm differs on {len(moves)} of "
          f"{len(weighted)} weighted layers "
          f"({json.dumps(plan_summary([(warm[i].kernel, False) for i in weighted]))})")
    t_warm = eng.run_warm(x_np)
    print(f"  run_warm: {t_warm:.4f} s (best of 3)")
    start = decided_arm_state(eng, "nnv12", "")
    ops.reset_launch_counts()
    sess = ContinuousSession(eng)
    r1 = sess.cold_infer(x_np)
    t0 = time.perf_counter()
    r2 = sess.warm_infer(x_np, wait=True)
    prep_wait = time.perf_counter() - t0 - r2.total_s
    r3 = sess.warm_infer(x_np, wait=True)
    counts = ops.launch_counts()
    switched = sorted(sess.warm_weights)
    print(f"  cold_infer [start: {start}]: total_s={r1.total_s:.4f} "
          f"stage_seconds={json.dumps(r1.stage_seconds())}")
    for n, r in (("2nd", r2), ("3rd", r3)):
        print(f"  warm_infer {n} (wait=True): total_s={r.total_s:.4f}, "
              f"{r.total_s / t_warm:.3f}x run_warm {t_warm:.4f} s")
    print(f"  switched {len(switched)} of {len(moves)} layers (the 2nd "
          f"warm_infer first waited {prep_wait:.4f} s for the warm preps); "
          f"launches={json.dumps({k: n for k, n in counts.items() if n})}")
    for n, r in (("cold_infer", r1), ("2nd warm_infer", r2),
                 ("3rd warm_infer", r3)):
        check_output(f"ContinuousSession {n}", r.output)
    if not switched:
        fail("ContinuousSession switched no layer")
    if switched != sorted(moves):
        fail(f"ContinuousSession switched {switched}, not {sorted(moves)}")
    used = set(cnn_kernels(layers, plan.choices)) | set(cnn_kernels(
        [l for l in layers if l.spec.name in switched],
        [c for l, c in zip(layers, warm) if l.spec.name in switched]))
    for k in sorted(used):
        if counts[k] <= 0:
            fail(f"kernel {k} never launched in the ContinuousSession runs")
    eng.set_plan(decided)
    return {k: counts[k] for k in used}


# the fleet phase's workers: an SD-card-class edge disk emulated under
# every local read (``--sim-disk-bytes-per-s``); the pinned plan is decided
# under it, so its read costs are the disk's
FLEET_DISK_BYTES_PER_S = 25e6
# the SIGKILL lands this long after the front door dispatched the request
# (the cold start it interrupts takes over a second at the disk's rate)
FLEET_KILL_AFTER_S = 0.1
FLEET_MODEL = dict(name="resnet50", image=224, width=1.0, classes=100,
                   seed=0)
FLEET_WORKERS = ("w0", "w1")


def fleet_plan(root, x_np, device, model):
    """The fleet's one plan: ``decide()`` with measured profiles, as a
    worker would, under the workers' emulated disk (an ``IOEngine`` of its
    own), written into every worker's store before ``add_model`` so each
    worker and restart serves it. Returns the deciding engine."""
    from repro_torch.core.engine import ColdEngine
    from repro_torch.core.scheduler import transfer_estimate
    from repro_torch.ioengine import IOEngine
    from repro_torch.models.cnn import build_cnn

    layers, _ = build_cnn(**model)
    io = IOEngine()
    io.set_sim_read_bandwidth(FLEET_DISK_BYTES_PER_S)
    try:
        eng = ColdEngine(layers, root / "plan", store_fmt="super",
                         io_engine=io, device=device)
        stats = eng.decide(x_np, n_little=2)
    finally:
        io.close()
    plan_json = (root / "plan" / "plan.json").read_text()
    for wid in FLEET_WORKERS:
        d = root / "fd" / wid / model["name"]
        d.mkdir(parents=True)
        (d / "plan.json").write_text(plan_json)
    summary = plan_summary((c.kernel, c.use_cache) for c in eng.plan.choices
                           if c.kernel != "fn")
    print(f"  pinned plan (measured, under the emulated disk): decide "
          f"{stats['plan_generation_s']:.2f} s, io_interference="
          f"{stats['io_interference']:.3f} est_makespan_s="
          f"{stats['est_makespan_s']:.6f} against the transfer estimate "
          f"{transfer_estimate(eng.store.model_bytes()):.6f} s of the "
          f"model's {eng.store.model_bytes()} B over an unmeasured link; "
          f"{json.dumps(summary)}")
    return eng


def fleet_path(card, x_np, ref_out, check_output, device="cuda",
               model=FLEET_MODEL) -> dict:
    """``FrontDoor(n_workers=2, device="cuda")`` serving resnet50@224 on one
    pinned measured plan: a SIGKILL mid cold start fails over to the
    sibling, which serves it from disk; the victim restarts; a cold start
    pinned to it races the sibling's RAM; then one warm run on each.
    Outputs bitwise equal across the workers. Returns the launches of the
    served requests (each result carries its own request's), which must be
    the plan's launches per forward times the forwards served. ``device``
    and ``model`` (``build_cnn``'s arguments) let the phase be rehearsed
    on the CPU at a small size."""
    import numpy as np
    import torch

    from repro_torch.executor.frontdoor import FrontDoor

    print(f"fleet: FrontDoor(n_workers=2, device='cuda') serving resnet50 "
          f"image=224 width=1.0, edge disk "
          f"{FLEET_DISK_BYTES_PER_S / 1e6:g} MB/s ({card})")
    served = []

    def show(label, res):
        served.append(res)
        peer = res.get("peer") or {}
        print(f"  {label}: worker {res['worker']} (pid {res['pid']}) "
              f"warm={res['warm']} total_s={res['total_s']:.4f} peer "
              f"layers={peer.get('layers_fetched', 0)} "
              f"bytes={peer.get('bytes_fetched', 0)} "
              f"won={peer.get('won', 0)} launches="
              f"{json.dumps({k: n for k, n in res['launches'].items() if n})}")

    def wait(cond, timeout_s, what):
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if cond():
                return
            time.sleep(0.02)
        fail(f"fleet: timed out waiting for {what}")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_fleet_") as tmp:
        pinned = fleet_plan(Path(tmp), x_np, device, model)
        fd = FrontDoor(Path(tmp) / "fd", n_workers=len(FLEET_WORKERS),
                       device=device, spawn_timeout_s=300.0,
                       worker_args={"store_fmt": "super",
                                    "sim_disk_bytes_per_s":
                                        FLEET_DISK_BYTES_PER_S})
        try:
            t0 = time.perf_counter()
            fd.start()
            t1 = time.perf_counter()
            fd.add_model("resnet50", "repro_torch.models.cnn:build_cnn",
                         **model)
            t2 = time.perf_counter()
            print(f"  spawn (CUDA context, kernel libraries) {t1 - t0:.2f} "
                  f"s; add_model on both workers (build, store, the pinned "
                  f"plan's cache) {t2 - t1:.2f} s")
            # SIGKILL mid cold start: failover to the sibling, from disk
            req = fd.request("resnet50", x_np, deadline_s=300.0,
                             worker="w0")
            wait(lambda: req.worker is not None, 60, "the first dispatch")
            time.sleep(FLEET_KILL_AFTER_S)
            fd.kill_worker("w0")
            t_kill = time.perf_counter()
            disk = req.result(timeout=300)
            show(f"cold start after SIGKILL of w0 {t_kill - t2:.2f} s in "
                 f"(failover, from disk; request wall "
                 f"{time.perf_counter() - t2:.2f} s)", disk)
            if disk["worker"] != "w1" or disk["warm"] or disk["peer"]:
                fail(f"fleet: the failover was not a cold start on w1: "
                     f"{disk['worker']} warm={disk['warm']}")
            check_output("fleet failover (w1, from disk)",
                         torch.from_numpy(disk["output"]).to(ref_out.device))
            wait(lambda: fd.health()["workers"]["w0"]["alive"]
                 and "resnet50" in fd._workers["w0"].ready_models, 300,
                 "w0's restart")
            h = fd.health()
            print(f"  w0 restarted {time.perf_counter() - t_kill:.2f} s "
                  f"after the kill: stats={json.dumps(h['stats'])}")
            left = (sum(w["in_flight"] for w in h["workers"].values()),
                    sum(h["queues"].values()))
            if h["stats"]["worker_restarts"] < 1 \
                    or h["stats"]["failovers"] < 1 or left != (0, 0):
                fail(f"fleet: restart/failover/leftovers wrong: {h}")
            # the restarted w0 cold-starts racing w1's RAM
            wait(lambda: "resnet50" in (fd._workers["w1"].health.get(
                "resident") or ()), 60, "w1's residency")
            raced = fd.request("resnet50", x_np, deadline_s=300.0,
                               worker="w0").result(timeout=300)
            show("cold start raced against w1's RAM", raced)
            peer = raced.get("peer") or {}
            if raced["worker"] != "w0" or raced["warm"] \
                    or peer.get("layers_fetched", 0) <= 0 \
                    or peer.get("crc_failures"):
                fail(f"fleet: the raced cold start took no peer layer: "
                     f"{raced['worker']} warm={raced['warm']} {peer}")
            if not np.array_equal(raced["output"], disk["output"]):
                fail("fleet: the peer-raced output differs from the "
                     "disk-served one")
            for wid in FLEET_WORKERS:
                again = fd.request("resnet50", x_np, deadline_s=300.0,
                                   worker=wid).result(timeout=300)
                show(f"warm run on {wid}", again)
                if not again["warm"] or not np.array_equal(
                        again["output"], disk["output"]):
                    fail(f"fleet: warm run on {wid} not warm or not "
                         f"bitwise equal")
            print(f"  outputs bitwise equal across workers, after the "
                  f"failover, peer- and disk-served")
        finally:
            fd.shutdown()
        per_forward = cnn_kernels(pinned.layers, pinned.plan.choices)
        counts = {k: sum(r["launches"].get(k, 0) for r in served)
                  for k in per_forward}
        print(f"  requests' launches {json.dumps(counts)}: "
              f"{json.dumps(per_forward)} a forward x {len(served)} "
              f"forwards served")
        for k, n in per_forward.items():
            if counts[k] != n * len(served):
                fail(f"fleet: {k} launched {counts[k]} times in the served "
                     f"requests, not {n} x {len(served)}")
        return counts


def main() -> None:
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: the repository's sources (src/repro_torch) are not "
              "beside this script", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        sys.exit(2)

    from repro_torch import quant
    from repro_torch.core.engine import ColdEngine
    from repro_torch.core.profiler import SyntheticProfiler
    from repro_torch.core.registry import ConvDirect
    from repro_torch.core.scheduler import Choice
    from repro_torch.device import resolve_device, set_f32_precision
    from repro_torch.executor.pool import reset_core_pool
    from repro_torch.ioengine import (StageEngine, reset_io_engine,
                                      reset_stage_engine)
    from repro_torch.kernels import _native, ops
    from repro_torch.kernels import quant as Q
    from repro_torch.kernels.attention import _flash_forward as flash_forward
    from repro_torch.kernels.attention import (decode_attention_plain,
                                               flash_attention_bwd_plain,
                                               flash_attention_plain,
                                               plan_decode, plan_flash,
                                               plan_flash_bwd)
    from repro_torch.kernels.attention import visible as attn_visible
    from repro_torch.kernels.conv_winograd import winograd_tile_matmul_plain
    from repro_torch.kernels.gmm import (gmm_blocks_dw_plain,
                                         gmm_blocks_plain, plan_gmm_dw)
    from repro_torch.kernels.matmul import (matmul_packed_plain, matmul_plain,
                                            plan_bf16_gemm, plan_f32_gemm)
    from repro_torch.kernels.ssd import _ssd_forward as ssd_forward
    from repro_torch.kernels.ssd import (plan_ssd, plan_ssd_bwd,
                                         ssd_scan_bwd_plain,
                                         ssd_scan_plain)
    from repro_torch.models.cnn import build_cnn

    # -- 1. the card --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "?"
    print(card)
    dev = resolve_device("cuda")
    set_f32_precision()
    name = torch.cuda.get_device_name(0)
    peaks = peak_rates(name)
    t_start = time.perf_counter()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name} count {torch.cuda.device_count()}")
    print(f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    # the port carries bf16 without ml_dtypes; report whether this machine
    # has it, without importing it
    try:
        ml_dtypes = f"installed {importlib.metadata.version('ml_dtypes')}"
    except importlib.metadata.PackageNotFoundError:
        ml_dtypes = "not installed"
    print(f"ml_dtypes: {ml_dtypes} (not used by the port)")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    print(f"peaks used for bounds: {peaks['float32'] / 1e12:.0f} TFLOP/s "
          f"f32 (CUDA cores), {peaks['bfloat16'] / 1e12:.0f} TFLOP/s bf16 "
          f"(tensor cores), {peaks['bytes'] / 1e12:.2f} TB/s")

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    _native.load_all()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"({_native.stats['built']} of {len(_native.SOURCES)} libraries "
          f"built, the rest found in {_native.build_dir()})")
    for src, log in _native.build_logs.items():
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill stores",
                                                log))
        if regs:
            print(f"  ptxas {src}: {len(regs)} kernels, {min(regs)}-"
                  f"{max(regs)} registers, {spills} bytes of spill stores")
        for line in [l for l in log.splitlines()
                     if "warning" in l.lower()][:8]:
            print(f"  nvcc {src}: {line.strip()[:200]}")

    # -- 3. kernels against their plain versions ------------------------------
    stream = torch.cuda.Stream(dev)
    rng = np.random.default_rng(0)

    def rand(*shape, dtype=torch.float32, scale=1.0):
        return (torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)) * scale).to(
                dev, dtype)

    def time_ms(fn, iters=20):
        with torch.cuda.stream(stream):
            for _ in range(3):
                fn()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            for _ in range(iters):
                fn()
            end.record(stream)
        end.synchronize()
        return start.elapsed_time(end) / iters

    def device_ms(fn, iters=20, library=False):
        """Device time of one call of ``fn``: ``iters`` calls captured in
        one CUDA graph, replayed and timed with CUDA events, so the host's
        cost of a wrapper call drops out. A port's wrapper that cannot be
        captured fails the run (decode is to run as CUDA graphs); a
        ``library`` call that cannot gives None."""
        try:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, stream=stream):
                for _ in range(iters):
                    fn()
            with torch.cuda.stream(stream):
                g.replay()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(stream)
                for _ in range(3):
                    g.replay()
                end.record(stream)
            end.synchronize()
            del g
            return start.elapsed_time(end) / (3 * iters)
        except Exception as e:
            if not library:
                fail(f"a kernel wrapper cannot be captured in a CUDA graph "
                     f"({type(e).__name__}: {e})")
            print(f"  (library call: no graph capture: "
                  f"{type(e).__name__}: {e})")
            torch.cuda.synchronize()
            return None

    def profiled_ms(fn, n=10):
        """Device time of one call of ``fn``: the summed device time of
        every kernel (and copy) its ``n`` calls launch, by
        ``torch.profiler`` (CUPTI), over n. The same ruler for a kernel
        and for a library call that cannot be captured in a graph
        (autograd's backward), so host gaps between the launches drop
        out of both."""
        from torch.profiler import ProfilerActivity, profile
        with torch.cuda.stream(stream):
            fn()
        stream.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with torch.cuda.stream(stream):
                for _ in range(n):
                    fn()
            stream.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages())
        return total / 1e3 / n if total > 0 else None

    def launch_split(fn, n=3):
        """Device ms a call of each kernel ``fn`` launches, by name
        (``torch.profiler`` over ``n`` calls on the check stream)."""
        from torch.profiler import ProfilerActivity, profile
        with torch.cuda.stream(stream):
            fn()
        stream.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with torch.cuda.stream(stream):
                for _ in range(n):
                    fn()
            stream.synchronize()
        out = {}
        for e in prof.key_averages():
            if e.self_device_time_total > 0:
                m = re.search(r"(\w+_kernel)", e.key)
                key = m.group(1) if m else e.key[:60]
                ms = e.self_device_time_total / 1e3 / n
                out[key] = out.get(key, 0.0) + ms
        return out

    def bound(flops, nbytes, dtype="float32"):
        t_ops, t_bytes = flops / peaks[dtype], nbytes / peaks["bytes"]
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")

    def nan_block(like):
        """Hand the caching allocator back a NaN-filled block of ``like``'s
        (shape, dtype) — or one of each, for a list — on the check stream,
        which the kernel's next output of that size takes: an output
        element the kernel skips stays NaN rather than the last call's
        value. Returns their addresses."""
        if like is None:
            return set()
        ts = [torch.full(shape, float("nan"), dtype=dt, device=dev)
              for shape, dt in (like if isinstance(like, list) else [like])]
        ptrs = {t.data_ptr() for t in ts}
        del ts
        return ptrs

    def outputs(r):
        return r if isinstance(r, tuple) else (r,)

    def library_or_error(name, fn):
        """``fn`` where one call of it runs on the card; otherwise None,
        the refusal printed in place of the library's time."""
        try:
            fn()
            torch.cuda.synchronize()
            return fn
        except Exception as e:
            torch.cuda.synchronize()
            print(f"  ({name} refused: {type(e).__name__}: "
                  f"{str(e).splitlines()[0][:160]})")
            return None

    def check(label, kernel, plain, library, flops, nbytes,
              dtype="float32", peak=None, exact=False, repeat_equal=False,
              nan_out=None, nan_scratch=None, library_graph=True,
              profiled=False, whole=True):
        """A kernel returning a tuple is held to its plain version output
        by output, each to its own max|plain|: the worst is reported. With
        ``repeat_equal`` a second launch on the same inputs must give the
        same bits. ``nan_out`` (shape, dtype), or a list of them for a
        kernel returning a tuple: each launch's outputs are first filled
        with NaN where the allocator hands them those blocks;
        ``nan_scratch`` (floats): so is a K split's f32 scratch.
        ``library_graph=False``: the library call is timed by events only
        (autograd's backward does not run on a capturing stream).
        ``profiled``: the kernel and the library call are also timed by
        ``profiled_ms`` (the summed device time of their own kernels), the
        one ruler that both take. A costed wrapper's cost function
        (``_native.costed``: its flops and bytes from the shapes) is
        printed beside the row's own count; where the row counts whole
        tensors (``whole``) they must agree within ``COST_TOL``, where it
        counts only the rows within groups or the visible cache entries
        the cost function's is the upper figure, printed only."""
        torch.cuda.synchronize()  # inputs were copied on the default stream
        scratch = (((nan_scratch,), torch.float32) if nan_scratch
                   else None)
        costs = []
        with torch.cuda.stream(stream):
            nan_block(scratch)
            nan_ptrs = nan_block(nan_out)
            _native.cost_sinks.append(lambda *c: costs.append(c[:3]))
            try:
                got = kernel()
            finally:
                _native.cost_sinks.pop()
            hits = sum(o.data_ptr() in nan_ptrs for o in outputs(got))
            ref = plain()
            if repeat_equal:
                nan_block(scratch)
                nan_ptrs = nan_block(nan_out)
                again = kernel()
                hits += sum(o.data_ptr() in nan_ptrs for o in outputs(again))
        stream.synchronize()
        if nan_out is not None:
            n_out = len(outputs(got)) * (1 + int(repeat_equal))
            print(f"  ({hits} of {n_out} launch outputs wrote "
                  f"into a NaN-filled block"
                  + (", each after a NaN-filled scratch block of "
                     f"{nan_scratch} floats" if scratch else "") + ")")
        if repeat_equal and not all(
                torch.equal(a, b) for a, b in
                (zip(got, again) if isinstance(got, tuple)
                 else [(got, again)])):
            fail(f"{label}: two launches on the same inputs differ")
        outs = zip(got, ref) if isinstance(got, tuple) else [(got, ref)]
        err, scale, finite = 0.0, 1e-30, True
        for g, r in outs:
            g, r = g.to(torch.float32), r.to(torch.float32)
            e, sc = (g - r).abs().max().item(), max(r.abs().max().item(), 1e-30)
            if e / sc >= err / scale:
                err, scale = e, sc
            finite = finite and bool(torch.isfinite(g).all())
        ms, plain_ms = time_ms(kernel), time_ms(plain)
        lib_ms = time_ms(library) if library is not None else None
        b_ms, b_by = bound(flops, nbytes, peak or dtype)
        # the redesigned kernels: device time too (the wrapper's host cost
        # bounds ms from below at small shapes)
        dev = {}
        if repeat_equal:
            dev["device_ms"] = device_ms(kernel)
            dev["library_device_ms"] = (device_ms(library, library=True)
                                        if library is not None
                                        and library_graph else None)

        if profiled:
            dev["profiled_ms"] = profiled_ms(kernel)
            dev["library_profiled_ms"] = (profiled_ms(library)
                                          if library is not None else None)

        def fmt(v):
            return "-" if v is None else f"{v:.4f}"

        print(f"  {label}: max|d|={err:.3e} rel={err / scale:.3e} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
              f"{fmt(lib_ms)} bound_ms={b_ms:.6f} ({b_by}, {peak or dtype} "
              f"peak)" + (f"; device_ms={fmt(dev['device_ms'])} "
                          f"library_device_ms="
                          f"{fmt(dev['library_device_ms'])}; two launches "
                          f"bitwise equal" if repeat_equal else "")
              + (f"; profiled_ms={fmt(dev['profiled_ms'])} "
                 f"library_profiled_ms={fmt(dev['library_profiled_ms'])}"
                 if profiled else ""))
        tol = 0.0 if exact else KERNEL_TOL[dtype]
        if not finite or err / scale > tol:
            fail(f"{label}: kernel disagrees with its plain version "
                 f"(rel {err / scale:.3e} > {tol})")
        cost = {}
        if costs:
            cf, cb = sum(c[1] for c in costs), sum(c[2] for c in costs)
            off = max(abs(cf - flops) / max(flops, 1),
                      abs(cb - nbytes) / max(nbytes, 1))
            print(f"    cost function ({'+'.join(c[0] for c in costs)}): "
                  f"flops={cf:.6g} bytes={cb:.6g}; the row's flops="
                  f"{flops:.6g} bytes={nbytes:.6g}: "
                  + (f"within {off:.2e} (gate {COST_TOL})" if whole else
                     "the cost function's the upper figure (the row counts "
                     "rows within groups or visible entries; not gated)"))
            if whole and off > COST_TOL:
                fail(f"{label}: the cost function's count is {off:.2e} off "
                     f"the row's")
            cost = {"cost_flops": cf, "cost_bytes": cb}
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                **dev, **cost}

    def visible_pairs(S, window):
        rows = np.arange(S)
        return int(np.minimum(rows + 1, window or S).sum())

    results = {}

    def bf16_row(tag, M, K, N, kmajor, draw=rand):
        """The bf16 ``matmul`` at (M, K) x (K, N) (``kmajor``: w a (N, K)
        tensor passed as its .T) against its plain version and
        ``torch.matmul``, inputs from ``draw``."""
        x = draw(M, K, dtype=torch.bfloat16)
        w = (draw(N, K, dtype=torch.bfloat16, scale=K ** -0.5).T if kmajor
             else draw(K, N, dtype=torch.bfloat16, scale=K ** -0.5))
        plan = plan_bf16_gemm(M, N, K)
        r = check(f"matmul_bf16 {tag} ({M},{K})x({K},{N}) "
                  f"{'K-major' if kmajor else 'row-major'} w, {plan.path} "
                  f"path bm {plan.bm} split {plan.split} ({plan.blocks} "
                  f"blocks)",
                  lambda: ops.matmul(x, w), lambda: matmul_plain(x, w),
                  lambda: torch.matmul(x, w),
                  2 * M * N * K, 2 * (M * K + K * N + M * N), "bfloat16",
                  repeat_equal=True)
        results.setdefault("matmul_bf16", {})[tag] = {
            **r, "path": plan.path, "split": plan.split}

    def flash_row(tag, B, S, H, KV, D, win, cap, dt, draw=rand):
        """Causal ``flash_attention`` (window ``win``, softcap ``cap``)
        against its plain version and, where it computes the same
        function (no window, no softcap), SDPA; inputs from ``draw``."""
        q = draw(B, S, H, D, dtype=dt, scale=0.5)
        k = draw(B, S, KV, D, dtype=dt, scale=0.5)
        v = draw(B, S, KV, D, dtype=dt, scale=0.5)
        kw = dict(causal=True, window=win, softcap=cap)
        lib = None
        if cap is None and win is None:
            lib = (lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True))
        dname = str(dt).replace("torch.", "")
        plan = plan_flash(B, S, H, KV, D, dt, True, win)
        r = check(f"flash_attention {tag} B={B} S={S} H={H} KV={KV} D={D} "
                  f"window={win} softcap={cap} {dname}, bq {plan.bq} heads "
                  f"{plan.heads} ksplit {plan.ksplit} bk {plan.bk} dp "
                  f"{plan.dp} ({plan.blocks} blocks of {plan.threads} "
                  f"threads)",
                  lambda: ops.flash_attention(q, k, v, **kw),
                  lambda: flash_attention_plain(q, k, v, **kw), lib,
                  4 * B * H * D * visible_pairs(S, win),
                  q.element_size() * 2 * B * S * (H + KV) * D, dname,
                  repeat_equal=True)
        results.setdefault("flash_attention", {})[tag] = {
            **r, "plan": plan._asdict()}

    def arch_rows():
        """The kernels at the archs path's shapes, each beside the library
        call that computes the same function where there is one. Inputs
        drawn on the card (a generator seeded 5): numpy's would take
        most of a minute for the 256000-wide head."""
        g = torch.Generator(device=dev).manual_seed(5)

        def rand(*shape, dtype=torch.float32, scale=1.0):
            return (torch.randn(shape, generator=g, device=dev)
                    * scale).to(dtype)

        print("kernels vs plain versions (the archs path's shapes: the bf16 "
              "matmul at qwen3-32b's 512-token prefill (q projection, MLP "
              "up, untied head) and gemma2-27b's 4608-token one (MLP up, "
              "the tied head reading embed (V, d) K-major in place); "
              "flash_attention at gemma2's 4608 tokens (window 4096 binding, "
              "softcap 50: no library call) and qwen3-32b's 64/8 heads; "
              "gmm_blocks at qwen3-moe-30b-a3b's 128 experts, top-8, d 2048 "
              "-> 768 and 768 -> 2048, at decode (C 8: one and four tokens) "
              "and a 512-token prefill (C 64), beside torch.bmm on the "
              "masked blocks):")
        for row in [("qwen3_32b_q_prefill", 512, 5120, 8192, False),
                    ("qwen3_32b_up_prefill", 512, 5120, 25600, False),
                    ("qwen3_32b_head_prefill", 512, 5120, 151936, False),
                    ("gemma2_up_prefill", 4608, 4608, 36864, False),
                    ("gemma2_head_tied_prefill", 4608, 4608, 256000, True)]:
            bf16_row(*row, draw=rand)
        torch.cuda.empty_cache()
        for row in [("gemma2_prefill4608_window_softcap", 1, 4608, 32, 16,
                     128, 4096, 50.0, torch.bfloat16),
                    ("qwen3_32b_prefill512", 1, 512, 64, 8, 128, None, None,
                     torch.bfloat16)]:
            flash_row(*row, draw=rand)
        # qwen3-moe's expert GEMMs under a top-8-of-128 routing (numpy
        # seed): one and four decode tokens (C 8, 8 and 32 rows) and a
        # 512-token prefill (C 64, the counts clipped there); the bound
        # counts the rows within the groups, the weights of the experts
        # that have any and the whole output
        E, k_top = 128, 8
        cases = []
        for T in (1, 4):
            picks = np.concatenate([rng.choice(E, k_top, replace=False)
                                    for _ in range(T)])
            cases.append((f"decode_T{T}", 8, np.bincount(picks, minlength=E)))
        picks = np.concatenate([rng.choice(E, k_top, replace=False)
                                for _ in range(512)])
        cases.append(("prefill512", 64, np.minimum(
            np.bincount(picks, minlength=E), 64)))
        for ptag, d, n in (("gate", 2048, 768), ("down", 768, 2048)):
            for gtag, C, gs_np in cases:
                x = rand(E, C, d, dtype=torch.bfloat16)
                w = rand(E, d, n, dtype=torch.bfloat16, scale=d ** -0.5)
                gs = torch.from_numpy(gs_np.astype(np.int32)).to(dev)
                keep = (torch.arange(C, device=dev)[None, :]
                        < gs[:, None])[..., None]
                xm = torch.where(keep, x, torch.zeros(
                    (), dtype=torch.bfloat16, device=dev))
                rows, active = int(gs_np.sum()), int((gs_np > 0).sum())
                plan = plan_bf16_gemm(C, n, d, E)
                tag = f"qwen3_moe_{gtag}_{ptag}"
                r = check(f"gmm_blocks {tag} ({E},{C},{d})x({E},{d},{n}) "
                          f"bfloat16, {rows} rows in {active} experts, "
                          f"{plan.path} path bm {plan.bm} split "
                          f"{plan.split} ({plan.blocks} blocks)",
                          lambda: ops.gmm_blocks(x, w, gs),
                          lambda: gmm_blocks_plain(x, w, gs),
                          lambda: torch.bmm(xm, w), 2 * rows * d * n,
                          2 * (rows * d + active * d * n + E * C * n),
                          "bfloat16", repeat_equal=True,
                          nan_out=((E, C, n), torch.bfloat16), whole=False)
                results.setdefault("gmm_blocks", {})[tag] = {
                    **r, "path": plan.path, "experts_read": active}
                del x, w, xm
        torch.cuda.empty_cache()

    paths = selected_paths()
    if paths is not None:
        # only the chosen paths (the archs path after its kernel rows): a
        # first check of a slice on the card, without a result line
        runs = {"serving": lambda: serving_path(dev, SERVE_DEPTH),
                "moe": lambda: moe_path(dev, MOE_DEPTH),
                "ssm": lambda: ssm_path(dev, SSM_DEPTH),
                "hybrid": lambda: hybrid_path(dev, HYBRID_DEPTH,
                                              HYBRID_F32_DEPTH),
                "archs": lambda: archs_path(dev)}
        for path in [x for x in ALONE if x in paths]:
            if path == "archs":
                t0 = time.perf_counter()
                arch_rows()
                print(f"  [archs kernel rows: "
                      f"{time.perf_counter() - t0:.1f} s]")
            t0 = time.perf_counter()
            runs[path]()
            torch.cuda.empty_cache()
            print(f"  [{path} path done in {time.perf_counter() - t0:.1f} "
                  f"s, at {time.perf_counter() - t_start:.1f} s]")
        print(f"chip_smoke: --paths {','.join(paths)}: stopped after the "
              f"chosen paths")
        sys.exit(0)

    print("kernels vs plain versions (resnet50@224 shapes):")
    # resnet50's four Winograd stages along plan_f32_gemm(..., batch=16)'s
    # paths (stream: stem, stage0; tile: stage1, stage2), then ragged edges:
    # two column tiles of the stream path (its U slab swapped between
    # items), a ragged tile path
    wino_shapes = [("stem", 12544, 3, 64), ("stage0", 12544, 64, 64),
                   ("stage1", 3136, 128, 128), ("stage2", 784, 256, 256),
                   ("ragged_stream", 300, 5, 70),
                   ("ragged_tile", 257, 100, 33)]
    for tag, T, C, O in wino_shapes:
        V, U = rand(16, T, C), rand(16, C, O)
        plan = plan_f32_gemm(T, O, C, False, 16)
        r = check(f"winograd_tile_matmul {tag} (16,{T},{C})x(16,{C},{O}), "
                  f"{plan.path} path {plan.bm}x{plan.bn} split {plan.split} "
                  f"({plan.blocks} blocks)",
                  lambda: ops.winograd_tile_matmul(V, U),
                  lambda: winograd_tile_matmul_plain(V, U),
                  lambda: torch.bmm(V, U),
                  2 * 16 * T * C * O, 4 * 16 * (T * C + C * O + T * O),
                  repeat_equal=True)
        results.setdefault("winograd_tile_matmul", {})[tag] = {
            **r, "path": plan.path, "tile": [plan.bm, plan.bn],
            "split": plan.split}
    # the f32 matmul along plan_f32_gemm's paths: resnet50's im2col GEMMs
    # and head, granite-moe-3b-a800m's f32 router (decode at 1 and 4
    # tokens, a 512-token prefill), mamba2-2.7b's f32 decode projections
    # and its tied head reading embed (V, d) K-major in place (decode and a
    # 1024-token prefill), ragged and unaligned edges. (tag, M, K, N,
    # K-major w, x offset in floats: 1 puts x off its 16-byte boundary)
    mm_rows = [("im2col_s1b0", 12544, 576, 128, False, 0),
               ("im2col_s2b0", 3136, 1152, 256, False, 0),
               ("head", 1, 256, 100, False, 0),
               ("granite_router_M1", 1, 1536, 40, False, 0),
               ("granite_router_M4", 4, 1536, 40, False, 0),
               ("granite_router_prefill", 512, 1536, 40, False, 0),
               ("mamba2_in_M1", 1, 2560, 5120, False, 0),
               ("mamba2_bc_M1", 1, 2560, 128, False, 0),
               ("mamba2_dt_M1", 1, 2560, 80, False, 0),
               ("mamba2_out_M1", 1, 5120, 2560, False, 0),
               ("mamba2_head_tied_M1", 1, 2560, 50280, True, 0),
               ("mamba2_head_tied_prefill", 1024, 2560, 50280, True, 0),
               ("mamba2_in_prefill", 1024, 2560, 5120, False, 0),
               ("ragged_skinny", 3, 129, 7, False, 0),
               ("ragged_tile", 100, 200, 4099, False, 0),
               ("ragged_kmajor_tile", 20, 37, 50, True, 0),
               ("ragged_kmajor_skinny", 5, 37, 50, True, 0),
               ("unaligned_x_skinny", 4, 1536, 40, False, 1),
               ("unaligned_x_tile", 64, 576, 128, False, 1),
               # the yardstick of matmul_packed's and matmul_dequant_int4's
               # rows of this shape
               ("up_f32", 64, 960, 2560, False, 0)]
    for tag, M, K, N, kmajor, shift in mm_rows:
        x = rand(M * K + shift)[shift:].view(M, K)
        w = rand(N, K).T if kmajor else rand(K, N)
        plan = plan_f32_gemm(M, N, K, kmajor)
        r = check(f"matmul {tag} ({M},{K})x({K},{N}) "
                  f"{'K-major' if kmajor else 'row-major'} w"
                  f"{', x off 16 B' if shift else ''}, {plan.path} path "
                  f"{plan.bm}x{plan.bn} split {plan.split} ({plan.blocks} "
                  f"blocks)",
                  lambda: ops.matmul(x, w), lambda: matmul_plain(x, w),
                  lambda: torch.matmul(x, w),
                  2 * M * N * K, 4 * (M * K + K * N + M * N),
                  repeat_equal=True)
        results.setdefault("matmul", {})[tag] = {
            **r, "path": plan.path, "tile": [plan.bm, plan.bn],
            "split": plan.split}
    # matmul_packed on the f32 path template along plan_f32_gemm(M, N, K):
    # resnet50's packed head (the main path's shape), a tblock up
    # projection in f32 and bf16 x beside the f32 matmul's row of the same
    # shape above, and ragged K and N (two panels, the second cut at 22
    # columns) on both paths; operations at the f32 peak (the weights are
    # f32, whatever x is). (tag, M, K, N, x dtype)
    for tag, M, K, N, dt in [("head", 1, 256, 100, torch.float32),
                             ("up_f32", 64, 960, 2560, torch.float32),
                             ("up_bf16", 64, 960, 2560, torch.bfloat16),
                             ("ragged_tile", 64, 300, 150, torch.float32),
                             ("ragged_skinny", 3, 300, 150, torch.bfloat16)]:
        nK, nN = -(-K // 128), -(-N // 128)
        x = rand(M, K, dtype=dt)
        wfull = rand(K, N, scale=K ** -0.5)
        wpad = torch.zeros(nK * 128, nN * 128, device=dev)
        wpad[:K, :N] = wfull
        wp = wpad.view(nK, 128, nN, 128).permute(2, 0, 1, 3).contiguous()
        plan = plan_f32_gemm(M, N, K)
        dname, es = str(dt).replace("torch.", ""), x.element_size()
        # library: one call of the same function, on the unpacked weight
        # where x is f32 (the packed head's K fills its panels: an einsum)
        lib = (None if dt != torch.float32
               else (lambda: torch.einsum("mkc,nkcd->mnd",
                                          x.view(M, nK, 128), wp)[:, 0])
               if K == nK * 128 and nN == 1 else (lambda: x @ wfull))
        r = check(f"matmul_packed {tag} ({M},{K})x({nN},{nK},128,128) "
                  f"{dname}, {plan.path} path {plan.bm}x{plan.bn} split "
                  f"{plan.split} ({plan.blocks} blocks)",
                  lambda: ops.matmul_packed(x, wp, K, N),
                  lambda: matmul_packed_plain(x, wp, K, N), lib,
                  # the kernel masks the zero rows and columns of each
                  # panel, so it reads the K*N real weights and no padding
                  2 * M * N * K, es * (M * K + M * N) + 4 * K * N, dname,
                  peak="float32", repeat_equal=True, nan_out=((M, N), dt))
        results.setdefault("matmul_packed", {})[tag] = {
            **r, "path": plan.path, "tile": [plan.bm, plan.bn],
            "split": plan.split}

    print("kernels vs plain versions (smollm-360m prefill shapes, bf16):")
    # the seven projections of a block (M = 64 prompt tokens) and the head
    for tag, M, K, N in [("d_model", 64, 960, 960), ("up", 64, 960, 2560),
                         ("down", 64, 2560, 960), ("head", 64, 960, 49152)]:
        x = rand(M, K, dtype=torch.bfloat16)
        w = rand(K, N, dtype=torch.bfloat16, scale=K ** -0.5)
        r = check(f"matmul_bf16 {tag} ({M},{K})x({K},{N})",
                  lambda: ops.matmul(x, w), lambda: matmul_plain(x, w),
                  lambda: torch.matmul(x, w),
                  2 * M * N * K, 2 * (M * K + K * N + M * N), "bfloat16",
                  repeat_equal=True)
        results.setdefault("matmul_bf16", {})[tag] = r

    print("kernels vs plain versions (bf16 matmul on the tensor cores: the "
          "decode projections at M 1 and 4 of smollm-360m, granite-moe-3b-"
          "a800m and mamba2-2.7b, mamba2's prefill projection, the tied "
          "heads reading embed (V, d) K-major in place, ragged and "
          "unaligned edges):")
    # (tag, M, K, N, K-major w: a (N, K) tensor passed as its .T)
    mm_rows = [("smollm_head_tied_M64", 64, 960, 49152, True)]
    for M in (1, 4):
        mm_rows += [(f"smollm_d_model_M{M}", M, 960, 960, False),
                    (f"smollm_up_M{M}", M, 960, 2560, False),
                    (f"smollm_down_M{M}", M, 2560, 960, False),
                    (f"smollm_head_tied_M{M}", M, 960, 49152, True),
                    (f"granite_q_o_M{M}", M, 1536, 1536, False),
                    (f"granite_kv_M{M}", M, 1536, 512, False),
                    (f"granite_head_tied_M{M}", M, 1536, 49155, True)]
    # the prefill projections and tied heads of granite (512 tokens) and
    # mamba2 (1024): the only 128-row tiles reading a K-major w
    mm_rows += [("granite_q_o_prefill", 512, 1536, 1536, False),
                ("granite_kv_prefill", 512, 1536, 512, False),
                ("granite_head_tied_prefill", 512, 1536, 49155, True),
                ("mamba2_in_prefill", 1024, 2560, 5120, False),
                ("mamba2_bc_prefill", 1024, 2560, 128, False),
                ("mamba2_dt_prefill", 1024, 2560, 80, False),
                ("mamba2_out_prefill", 1024, 5120, 2560, False),
                ("mamba2_head_tied_prefill", 1024, 2560, 50280, True),
                ("mamba2_in_M4", 4, 2560, 5120, False),
                ("mamba2_out_M4", 4, 5120, 2560, False),
                ("mamba2_head_tied_M4", 4, 2560, 50280, True),
                # internvl2-76b's prefill (256 prefix embeddings and 64
                # text tokens): its MLP up and down projections and its
                # untied head
                ("internvl2_up_prefill", 320, 8192, 28672, False),
                ("internvl2_down_prefill", 320, 28672, 8192, False),
                ("internvl2_head_prefill", 320, 8192, 128256, False),
                # scalar copies: K, N or both not a multiple of 8
                ("ragged_skinny", 3, 129, 7, False),
                ("ragged_tile", 100, 200, 49155, False),
                ("ragged_kmajor", 20, 37, 50, True),
                ("unaligned_n_skinny", 5, 1536, 49155, False)]
    # the backward GEMMs of the training path at smollm-360m's widths (a
    # microbatch of 4 x 512 = 2048 tokens): dx = dy (2048, N) · wᵀ, w read
    # in place K-major (the tied head's embed row-major); dw = xᵀ (K, 2048)
    # · dy, a contraction over the 2048 tokens
    mm_rows += [("bwd_dx_qo", 2048, 960, 960, True),
                ("bwd_dx_kv", 2048, 320, 960, True),
                ("bwd_dx_up", 2048, 2560, 960, True),
                ("bwd_dx_down", 2048, 960, 2560, True),
                ("bwd_dx_head_tied", 2048, 49152, 960, False),
                ("bwd_dw_qo", 960, 2048, 960, False),
                ("bwd_dw_kv", 960, 2048, 320, False),
                ("bwd_dw_up", 960, 2048, 2560, False),
                ("bwd_dw_down", 2560, 2048, 960, False),
                ("bwd_dw_head", 960, 2048, 49152, False)]
    for row in mm_rows:
        bf16_row(*row)

    # (tag, B, S, H, KV, D, window, softcap, dtype); causal throughout.
    # smollm-360m's cold prefill and a long one, granite-moe-3b-a800m's
    # 512-token prefill, zamba2-2.7b's head dim 80 in both dtypes, ragged
    # S, the head dims off the 16-byte grid (67: element loads), 100 and
    # 256, and a plan with two query heads a block
    for row in [
            ("prefill64", 1, 64, 15, 5, 64, None, None, torch.bfloat16),
            ("prefill2048", 1, 2048, 15, 5, 64, None, None, torch.bfloat16),
            ("granite512", 1, 512, 24, 8, 64, None, None, torch.bfloat16),
            ("zamba2_d80", 1, 1024, 32, 32, 80, None, None, torch.bfloat16),
            ("zamba2_d80_f32", 1, 1024, 32, 32, 80, None, None,
             torch.float32),
            ("internvl2_prefill320", 1, 320, 64, 8, 128, None, None,
             torch.bfloat16),
            ("musicgen_prefill512", 1, 512, 24, 24, 64, None, None,
             torch.bfloat16),
            ("ragged100", 1, 100, 15, 5, 64, None, None, torch.bfloat16),
            ("f32_window_softcap", 1, 1024, 15, 5, 64, 256, 50.0,
             torch.float32),
            ("d32_window", 2, 200, 8, 2, 32, 64, None, torch.bfloat16),
            ("d128_softcap", 2, 130, 4, 4, 128, None, 30.0, torch.bfloat16),
            ("d100_window_softcap", 1, 300, 8, 2, 100, 128, 30.0,
             torch.bfloat16),
            ("d67_window", 1, 200, 4, 2, 67, 64, None, torch.bfloat16),
            ("d256", 1, 256, 4, 4, 256, None, None, torch.bfloat16),
            # a batch with 8 query heads a kv head: two heads a block
            ("batched_gqa", 8, 256, 32, 4, 128, None, None,
             torch.bfloat16)]:
        flash_row(*row)

    print("kernels vs plain versions (flash_attention_bwd, the backward of "
          "prefill attention, along plan_flash_bwd's route: smollm-360m's "
          "training attention at (8, 512, 15/5, 64) and one microbatch (4, "
          "512) in bf16, (8, 512) in f32, zamba2-2.7b's training microbatch "
          "(4, 512, 32/32, 80) in bf16, a windowed, softcapped bf16 shape "
          "of gemma2's kind, a ragged S with a head off the 16-byte grid "
          "and a window, and a 256-wide bf16 head (the CUDA-core route); "
          "the bound counts five products of the visible pairs (one "
          "recompute of the scores) at the inputs' peak; library: SDPA's "
          "backward through autograd, a comparison only; profiled: the "
          "summed device time of the kernels each call launches, by "
          "torch.profiler, for both):")
    for tag, B, S, H, KV, D, win, cap, dt in [
            ("smollm_B8", 8, 512, 15, 5, 64, None, None, torch.bfloat16),
            ("smollm_mb", 4, 512, 15, 5, 64, None, None, torch.bfloat16),
            ("smollm_B8_f32", 8, 512, 15, 5, 64, None, None, torch.float32),
            ("zamba2_mb", 4, 512, 32, 32, 80, None, None, torch.bfloat16),
            ("gemma2_window_softcap", 1, 1024, 32, 16, 128, 256, 50.0,
             torch.bfloat16),
            ("ragged_d67_window", 2, 100, 6, 2, 67, 40, None,
             torch.bfloat16),
            ("d256", 1, 256, 4, 4, 256, None, None, torch.bfloat16)]:
        q = rand(B, S, H, D, dtype=dt, scale=0.5)
        k = rand(B, S, KV, D, dtype=dt, scale=0.5)
        v = rand(B, S, KV, D, dtype=dt, scale=0.5)
        do = rand(B, S, H, D, dtype=dt)
        kw = dict(causal=True, window=win, softcap=cap)
        o, lse = flash_forward(q, k, v, True, win, cap, True)
        lib = None
        if cap is None and win is None:
            # the forward on the check stream, where autograd then runs
            # the backward that the events time
            with torch.cuda.stream(stream):
                qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                              for t in (q, k, v))
                ot = F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
            stream.synchronize()
            lib = (lambda ot=ot, ins=(qt, kt, vt), g=do.transpose(1, 2):
                   torch.autograd.grad(ot, ins, g, retain_graph=True))
        dname = str(dt).replace("torch.", "")
        plan = plan_flash_bwd(B, S, H, KV, D, dt, True, win)
        r = check(f"flash_attention_bwd {tag} B={B} S={S} H={H} KV={KV} "
                  f"D={D} window={win} softcap={cap} {dname} (three "
                  f"launches: delta, dK/dV, dQ), route {plan.route} dp "
                  f"{plan.dp} rows {plan.rows} ({plan.blocks_dkdv} + "
                  f"{plan.blocks_dq} blocks of {plan.threads} threads)",
                  lambda: ops.flash_attention_bwd(q, k, v, o, lse, do, **kw),
                  lambda: flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                    **kw), lib,
                  10 * B * H * D * visible_pairs(S, win),
                  q.element_size() * 4 * B * S * (H + KV) * D + 4 * B * H * S,
                  dname, repeat_equal=True,
                  nan_out=[((B, S, H, D), dt), ((B, S, KV, D), dt),
                           ((B, S, KV, D), dt)], library_graph=False,
                  profiled=True)
        results.setdefault("flash_attention_bwd", {})[tag] = {
            **r, "plan": plan._asdict()}
        del q, k, v, do, o, lse, lib

    print("kernels vs plain versions (decode_attention: the Pallas sweep in "
          "its prefix form, smollm-360m decode shapes, a wrapped ring with a "
          "window, the int8 cache, a softcap):")

    def decode_case(tag, B, W, H, KV, D, dt, pos, window=None, softcap=None,
                    int8=False):
        """Hold decode_attention against its plain version; bound by the
        bytes of the visible cache entries (the kernel reads no other),
        q, the output and pos; SDPA with the same mask where it computes
        the same function (no softcap, no int8 cache)."""
        q = rand(B, H, D, dtype=dt, scale=0.5)
        es = q.element_size()
        if int8:
            k, v = (torch.from_numpy(rng.integers(
                -127, 128, (B, W, KV, D)).astype(np.int8)).to(dev)
                for _ in range(2))
            ks, vs = (torch.from_numpy((rng.random((B, W, KV)) * 0.02
                                        + 1e-3).astype(np.float32)).to(dev)
                      for _ in range(2))
            entry_b = KV * (2 * D + 2 * 4)
        else:
            k, v = rand(B, W, KV, D, dtype=dt), rand(B, W, KV, D, dtype=dt)
            ks = vs = None
            entry_b = 2 * KV * D * es
        p = torch.tensor(pos, dtype=torch.int32, device=dev)
        mask = attn_visible(p, W, window)
        n_vis = int(mask.sum().item())
        kw = dict(window=window, softcap=softcap, k_scale=ks, v_scale=vs)
        lib = None
        if not int8 and softcap is None:
            qs, kt, vt = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
            m4 = mask[:, None, None, :]
            lib = (lambda: F.scaled_dot_product_attention(
                qs, kt, vt, attn_mask=m4, enable_gqa=True))
        dname = str(dt).replace("torch.", "")
        plan = plan_decode(B, W, H, KV, D)
        r = check(f"decode_attention {tag} B={B} W={W} H={H} KV={KV} D={D} "
                  f"window={window} softcap={softcap} "
                  f"{'int8 cache' if int8 else dname} visible={n_vis}; "
                  f"split {plan.split} of {plan.chunk} entries, {plan.hg} "
                  f"heads a block, {plan.lpr} lanes a row ({plan.blocks} "
                  f"blocks)",
                  lambda: ops.decode_attention(q, k, v, p, **kw),
                  lambda: decode_attention_plain(q, k, v, p, **kw), lib,
                  4 * H * D * n_vis,
                  n_vis * entry_b + 2 * B * H * D * es + 4 * B, dname,
                  repeat_equal=True, whole=n_vis == B * W)
        results.setdefault("decode_attention", {})[tag] = {
            **r, "split": plan.split, "chunk": plan.chunk}

    # the Pallas sweep (tests/test_kernels.py), prefix lengths as positions
    for S, H, KV, D in [(512, 8, 4, 64), (300, 4, 4, 32), (256, 8, 2, 128)]:
        lens = rng.integers(1, S + 1, size=3)
        decode_case(f"sweep_S{S}_D{D}", 3, S, H, KV, D, torch.float32,
                    [int(n) - 1 for n in lens])
    # smollm-360m: 15 heads, 5 kv heads, D 64; a full cache (pos = W - 1);
    # W 82 is the cold-start decode's max_len, 512 the batched server's
    for B in (1, 4):
        for W in (82, 512, 4096):
            for dt in (torch.bfloat16, torch.float32):
                decode_case(f"B{B}_W{W}_{str(dt)[6:]}", B, W, 15, 5, 64, dt,
                            [W - 1] * B)
    decode_case("ring_window32_W32", 2, 32, 15, 5, 64, torch.bfloat16,
                [47, 40], window=32)
    decode_case("ring_window1024_W4096", 4, 4096, 15, 5, 64, torch.bfloat16,
                [5000, 4200, 9000, 4095], window=1024)
    decode_case("int8_B4_W512", 4, 512, 15, 5, 64, torch.bfloat16,
                [511] * 4, int8=True)
    decode_case("int8_ring_B4_W4096", 4, 4096, 15, 5, 64, torch.bfloat16,
                [6000, 4095, 5000, 7000], window=2048, int8=True)
    decode_case("softcap_d128", 2, 1024, 32, 16, 128, torch.bfloat16,
                [1023, 700], window=512, softcap=50.0)
    # granite-moe-3b-a800m (24 heads, 8 kv heads, D 64)
    for B, W in ((1, 512), (4, 4096)):
        decode_case(f"granite_B{B}_W{W}", B, W, 24, 8, 64, torch.bfloat16,
                    [W - 1] * B)
    # zamba2-2.7b's shared attention (32 heads, 32 kv heads, D 80)
    decode_case("zamba2_d80_B1_W4096", 1, 4096, 32, 32, 80, torch.bfloat16,
                [4095])
    decode_case("zamba2_d80_ring_B4_W512", 4, 512, 32, 32, 80,
                torch.bfloat16, [700, 511, 100, 1500], window=256)
    decode_case("d80_int8_B2_W512", 2, 512, 32, 32, 80, torch.bfloat16,
                [511, 300], int8=True)
    # internvl2-76b (64 heads, 8 kv heads, D 128) and musicgen-medium
    # (24/24, D 64)
    decode_case("internvl2_B1_W512", 1, 512, 64, 8, 128, torch.bfloat16,
                [511])
    decode_case("internvl2_B4_W4096", 4, 4096, 64, 8, 128, torch.bfloat16,
                [4095] * 4)
    decode_case("musicgen_B1_W512", 1, 512, 24, 24, 64, torch.bfloat16,
                [511])
    # head dims that are not a multiple of 8: 100 in f32 (16-byte rows, a
    # lane with half a chunk), 67 in bf16 (134-byte rows: element loads)
    decode_case("d100_f32", 2, 600, 8, 2, 100, torch.float32, [599, 250])
    decode_case("d67_bf16_softcap", 2, 600, 6, 3, 67, torch.bfloat16,
                [599, 1000], window=300, softcap=30.0)
    decode_case("d256_bf16", 1, 1024, 8, 1, 256, torch.bfloat16, [1023])

    print("kernels vs plain versions (quantized cache: smollm-360m block "
          "and head, resnet50 head):")
    # a tblock's seven projections and the LM head, then ragged shapes
    # (odd K for int4); exact: one f32 multiply of exact values
    for tag, K, N in [("d_model", 960, 960), ("kv", 960, 320),
                      ("up", 960, 2560), ("down", 2560, 960),
                      ("head", 960, 49152), ("ragged37x16", 37, 16),
                      ("ragged129x7", 129, 7)]:
        a = rng.standard_normal((K, N)).astype(np.float32) * K ** -0.5
        q8, s8, _ = quant.quantize_int8(a)
        p4, s4 = quant.quantize_int4(a)
        tq8, ts8, tp4, ts4 = (torch.from_numpy(v).to(dev)
                              for v in (q8, s8, p4, s4))
        r = check(f"dequant_int8 {tag} ({K},{N})",
                  lambda: ops.dequant_int8(tq8, ts8),
                  lambda: Q.dequant_int8_plain(tq8, ts8),
                  lambda: torch.mul(tq8, ts8),
                  K * N, K * N + 4 * N + 4 * K * N, exact=True)
        results.setdefault("dequant_int8", {})[tag] = r
        r = check(f"dequant_int4 {tag} ({K},{N})",
                  lambda: ops.dequant_int4(tp4, ts4, K),
                  lambda: Q.dequant_int4_plain(tp4, ts4, K), None,
                  K * N, (K + 1) // 2 * N + 4 * N + 4 * K * N, exact=True)
        results.setdefault("dequant_int4", {})[tag] = r
    # the fused kernels: resnet50's head (the main path's shape), a tblock
    # up projection in f32 and bf16, a ragged case; for the loaders, a
    # decode projection at M 1 (16-byte loads) and M 8 (4-byte), and
    # ragged tiles with an odd K (4-byte and 1-byte copies); operations at
    # the peak of x's type (int8 and int4 weights are exact in bf16, so
    # bf16 x could run at the bf16 tensor-core rate). The int8 rows' library
    # call: torch._weight_int8pack_mm(x, q^T, s), (x · q) · s in one call,
    # with q^T made outside the timed window; where the card refuses it,
    # the row prints the error in place of a time
    for tag, M, K, N, dt in [
            ("resnet_head", 1, 256, 100, torch.float32),
            ("up_f32", 64, 960, 2560, torch.float32),
            ("up_bf16", 64, 960, 2560, torch.bfloat16),
            ("ragged", 3, 129, 7, torch.float32),
            ("up_M1", 1, 960, 2560, torch.float32),
            ("up_M8", 8, 960, 2560, torch.bfloat16),
            ("ragged_tile", 64, 129, 100, torch.bfloat16),
            ("ragged_tile_bytes", 20, 37, 7, torch.float32)]:
        x = rand(M, K, dtype=dt)
        a = rng.standard_normal((K, N)).astype(np.float32) * K ** -0.5
        q8, s8, _ = quant.quantize_int8(a)
        p4, s4 = quant.quantize_int4(a)
        tq8, ts8, tp4, ts4 = (torch.from_numpy(v).to(dev)
                              for v in (q8, s8, p4, s4))
        dname, es = str(dt).replace("torch.", ""), x.element_size()
        io = es * M * K + 4 * N + es * M * N
        plan = plan_f32_gemm(M, N, K)
        qT, sv = tq8.T.contiguous(), ts8.view(-1)
        lib8 = library_or_error(
            "torch._weight_int8pack_mm",
            lambda: torch._weight_int8pack_mm(x, qT, sv))
        loader = Q.q_loader(tq8, M, plan.path)
        r = check(f"matmul_dequant_int8 {tag} ({M},{K})x({K},{N}) {dname}, "
                  f"{plan.path} path {plan.bm}x{plan.bn} split {plan.split} "
                  f"({plan.blocks} blocks), {loader}-byte loader",
                  lambda: ops.matmul_dequant_int8(x, tq8, ts8),
                  lambda: Q.matmul_dequant_int8_plain(x, tq8, ts8), lib8,
                  2 * M * N * K, io + K * N, dname,
                  repeat_equal=True, nan_out=((M, N), dt))
        results.setdefault("matmul_dequant_int8", {})[tag] = {
            **r, "path": plan.path, "tile": [plan.bm, plan.bn],
            "split": plan.split, "loader_bytes": loader}
        loader = Q.q_loader(tp4, M, plan.path)
        r = check(f"matmul_dequant_int4 {tag} ({M},{K})x({K},{N}) {dname}, "
                  f"{plan.path} path {plan.bm}x{plan.bn} split {plan.split} "
                  f"({plan.blocks} blocks), {loader}-byte loader",
                  lambda: ops.matmul_dequant_int4(x, tp4, ts4, K),
                  lambda: Q.matmul_dequant_int4_plain(x, tp4, ts4, K), None,
                  2 * M * N * K, io + (K + 1) // 2 * N, dname,
                  repeat_equal=True, nan_out=((M, N), dt))
        results.setdefault("matmul_dequant_int4", {})[tag] = {
            **r, "path": plan.path, "tile": [plan.bm, plan.bn],
            "split": plan.split, "loader_bytes": loader}
    # the bf16 matmul's f32-out entry at LinearLowPrecision's resnet50 head;
    # the products of bf16 values are exact in f32, so the f32 tolerance
    M, K, N = 1, 256, 100
    x = rand(M, K, dtype=torch.bfloat16)
    w = rand(K, N, dtype=torch.bfloat16, scale=K ** -0.5)
    r = check(f"matmul_bf16 f32-out resnet_head ({M},{K})x({K},{N})",
              lambda: ops.matmul(x, w, out_dtype=torch.float32),
              lambda: matmul_plain(x, w, torch.float32), None,
              2 * M * N * K, 2 * (M * K + K * N) + 4 * M * N, "float32",
              peak="bfloat16")
    results["matmul_bf16"]["resnet_head_f32out"] = r
    # and at mamba2's prefill projection, the one bound by operations
    M, K, N = 1024, 2560, 5120
    x = rand(M, K, dtype=torch.bfloat16)
    w = rand(K, N, dtype=torch.bfloat16, scale=K ** -0.5)
    r = check(f"matmul_bf16 f32-out mamba2_in_prefill ({M},{K})x({K},{N})",
              lambda: ops.matmul(x, w, out_dtype=torch.float32),
              lambda: matmul_plain(x, w, torch.float32), None,
              2 * M * N * K, 2 * (M * K + K * N) + 4 * M * N, "float32",
              peak="bfloat16", repeat_equal=True)
    results["matmul_bf16"]["mamba2_in_prefill_f32out"] = r

    print("kernels vs plain versions (gmm_blocks: granite-moe-3b-a800m's "
          "expert GEMMs at decode and at a 512-token prefill, bf16; the "
          "Pallas sweep in f32 and bf16):")
    # (tag, E, C, d, n, dtype); C = 8 at decode (4 slots x top-8 of 40
    # experts), 208 at a 512-token prefill (capacity factor 2)
    for tag, E, C, d, n, dt in [
            ("decode_gate", 40, 8, 1536, 512, torch.bfloat16),
            ("decode_down", 40, 8, 512, 1536, torch.bfloat16),
            ("prefill_gate", 40, 208, 1536, 512, torch.bfloat16),
            ("sweep_4x64x32x48_f32", 4, 64, 32, 48, torch.float32),
            ("sweep_8x128x128x128_f32", 8, 128, 128, 128, torch.float32),
            ("sweep_3x40x20x9_f32", 3, 40, 20, 9, torch.float32),
            ("sweep_4x64x32x48_bf16", 4, 64, 32, 48, torch.bfloat16),
            ("sweep_8x128x128x128_bf16", 8, 128, 128, 128, torch.bfloat16),
            ("sweep_3x40x20x9_bf16", 3, 40, 20, 9, torch.bfloat16)]:
        x = rand(E, C, d, dtype=dt)
        w = rand(E, d, n, dtype=dt, scale=d ** -0.5)
        dname, es = str(dt).replace("torch.", ""), x.element_size()
        r = check(f"gmm_blocks {tag} ({E},{C},{d})x({E},{d},{n}) {dname}",
                  lambda: ops.gmm_blocks(x, w), lambda: gmm_blocks_plain(x, w),
                  lambda: torch.bmm(x, w), 2 * E * C * d * n,
                  es * (E * C * d + E * d * n + E * C * n), dname,
                  repeat_equal=True)
        results.setdefault("gmm_blocks", {})[tag] = r
    # with group sizes: decode's top-8-of-40 routing of 1 and of 4 tokens
    # (C 8), a 512-token prefill's counts clipped at C 208 with two idle
    # experts, and the f32 entry with an empty, a partial and a full
    # expert. The bound counts what these sizes need: the rows that hold
    # tokens, the weights of the experts that have any, the whole output;
    # no single PyTorch call computes this function, so no library time
    E, d, n = 40, 1536, 512
    routed_cases = []
    for T in (1, 4):
        picks = np.concatenate([rng.choice(E, 8, replace=False)
                                for _ in range(T)])
        routed_cases.append((f"decode_gate_routed_T{T}", 8,
                             np.bincount(picks, minlength=E), torch.bfloat16))
    counts = np.minimum(rng.multinomial(512 * 8, np.ones(E) / E), 208)
    counts[[3, 17]] = 0
    routed_cases.append(("prefill_gate_routed", 208, counts, torch.bfloat16))
    for tag, C, gs_np, dt in routed_cases:
        x = rand(E, C, d, dtype=dt)
        w = rand(E, d, n, dtype=dt, scale=d ** -0.5)
        gs = torch.from_numpy(gs_np.astype(np.int32)).to(dev)
        rows, active = int(gs_np.sum()), int((gs_np > 0).sum())
        r = check(f"gmm_blocks {tag} ({E},{C},{d})x({E},{d},{n}) bfloat16, "
                  f"{rows} rows in {active} experts",
                  lambda: ops.gmm_blocks(x, w, gs),
                  lambda: gmm_blocks_plain(x, w, gs), None,
                  2 * rows * d * n, 2 * (rows * d + active * d * n + E * C * n),
                  "bfloat16", repeat_equal=True, whole=False)
        results["gmm_blocks"][tag] = {**r, "experts_read": active}
    for dt in (torch.float32, torch.bfloat16):
        E3, C3, d3, n3 = 3, 40, 20, 9
        x, w = rand(E3, C3, d3, dtype=dt), rand(E3, d3, n3, dtype=dt)
        gs = torch.tensor([0, 17, 40], dtype=torch.int32, device=dev)
        dname = str(dt).replace("torch.", "")
        split = (plan_f32_gemm(C3, n3, d3, False, E3, True).split
                 if dt == torch.float32 else plan_bf16_gemm(C3, n3, d3,
                                                            E3).split)
        r = check(f"gmm_blocks sweep_3x40x20x9_group_sizes_0_17_40 {dname}, "
                  f"split {split}",
                  lambda: ops.gmm_blocks(x, w, gs),
                  lambda: gmm_blocks_plain(x, w, gs), None,
                  2 * 57 * d3 * n3,
                  x.element_size() * (57 * d3 + 2 * d3 * n3 + E3 * C3 * n3),
                  dname, repeat_equal=True, nan_out=((E3, C3, n3), dt),
                  nan_scratch=split * E3 * C3 * n3 if split > 1 else None,
                  whole=False)
        results["gmm_blocks"][f"sweep_group_sizes_{dname}"] = r
    # the f32 entry at granite-moe-3b-a800m's widths, along plan_f32_gemm(
    # C, n, d, batch=E, row_limit=True): the batched skinny path at
    # decode (C 8) and the batched tile path at a 512-token prefill (C 208),
    # without group sizes (torch.bmm beside them) and routed as above (the
    # bound counts what the sizes need; no library call computes it)
    f32_cases = [("decode_gate_f32", 8, None),
                 ("decode_gate_routed_T1_f32", 8, routed_cases[0][2]),
                 ("decode_gate_routed_T4_f32", 8, routed_cases[1][2]),
                 ("prefill_gate_f32", 208, None),
                 ("prefill_gate_routed_f32", 208, routed_cases[2][2])]
    for tag, C, gs_np in f32_cases:
        x = rand(E, C, d)
        w = rand(E, d, n, scale=d ** -0.5)
        plan = plan_f32_gemm(C, n, d, False, E, True)
        desc = (f"{plan.path} path {plan.bm}x{plan.bn} split {plan.split} "
                f"({plan.blocks} blocks)")
        scratch = plan.split * E * C * n if plan.split > 1 else None
        if gs_np is None:
            r = check(f"gmm_blocks {tag} ({E},{C},{d})x({E},{d},{n}) "
                      f"float32, {desc}",
                      lambda: ops.gmm_blocks(x, w),
                      lambda: gmm_blocks_plain(x, w),
                      lambda: torch.bmm(x, w), 2 * E * C * d * n,
                      4 * (E * C * d + E * d * n + E * C * n),
                      repeat_equal=True, nan_out=((E, C, n), torch.float32),
                      nan_scratch=scratch)
            results["gmm_blocks"][tag] = {**r, "path": plan.path}
            continue
        gs = torch.from_numpy(gs_np.astype(np.int32)).to(dev)
        rows, active = int(gs_np.sum()), int((gs_np > 0).sum())
        r = check(f"gmm_blocks {tag} ({E},{C},{d})x({E},{d},{n}) float32, "
                  f"{rows} rows in {active} experts, {desc}",
                  lambda: ops.gmm_blocks(x, w, gs),
                  lambda: gmm_blocks_plain(x, w, gs), None,
                  2 * rows * d * n,
                  4 * (rows * d + active * d * n + E * C * n),
                  repeat_equal=True, nan_out=((E, C, n), torch.float32),
                  nan_scratch=scratch, whole=False)
        results["gmm_blocks"][tag] = {**r, "path": plan.path,
                                      "experts_read": active}

    print("kernels vs plain versions (the MoE backward: gmm_blocks' dx "
          "with w read K-major in place and gmm_blocks_dw, at "
          "granite-moe-3b-a800m's training microbatch: 2048 tokens, top-8 "
          "of 40, C 824, in bf16 and f32):")
    # the four products of _GroupedFFN's backward: dh = dyb (E,C,d)·wdᵀ
    # and dblk's dg (E,C,ff)·wgᵀ (gmm_blocks, the forward's weight read
    # K-major in place); dwg = blkᵀ·dg and dwd = hᵀ·dyb (gmm_blocks_dw,
    # contracted over each expert's rows). Group sizes: a top-8-of-40
    # routing of 2048 tokens (numpy seed) and all experts full. The
    # inputs' rows past a group hold data (in the model: the next
    # expert's tokens); torch.bmm, the library call, takes them masked.
    # Bounds count what the sizes need: the rows within the groups, the
    # weights of the experts that have any (dx), the whole output.
    E, C, d, ff = 40, MOE_TRAIN_C, 1536, 512
    picks = np.concatenate([rng.choice(E, 8, replace=False)
                            for _ in range(TRAIN_BATCH * TRAIN_SEQ
                                           // TRAIN_MICRO)])
    bwd_sizes = {"routed": np.minimum(np.bincount(picks, minlength=E), C),
                 "full": np.full(E, C)}
    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).replace("torch.", "")
        sfx = "" if dt == torch.bfloat16 else "_f32"
        for gtag, gs_np in bwd_sizes.items():
            gs = torch.from_numpy(gs_np.astype(np.int32)).to(dev)
            keep = (torch.arange(C, device=dev)[None, :]
                    < gs[:, None])[..., None]
            rows, active = int(gs_np.sum()), int((gs_np > 0).sum())
            es = 2 if dt == torch.bfloat16 else 4
            # dx: (tag, K = d_in, N = d_out); w stored (E, N, K)
            for tag, K, N in (("dh", d, ff), ("dblk", ff, d)):
                x = rand(E, C, K, dtype=dt)
                w = rand(E, N, K, dtype=dt, scale=K ** -0.5)
                wt = w.transpose(1, 2)
                xm = torch.where(keep, x, torch.zeros((), dtype=dt,
                                                      device=dev))
                plan = (plan_bf16_gemm(C, N, K, E) if dt == torch.bfloat16
                        else plan_f32_gemm(C, N, K, True, E, True))
                r = check(f"gmm_blocks bwd_{tag}_{gtag}{sfx} ({E},{C},{K})x"
                          f"({E},{K},{N}) w K-major {dname}, {rows} rows in "
                          f"{active} experts, {plan.path} path {plan.bm}x"
                          f"{plan.bn} split {plan.split} ({plan.blocks} "
                          f"blocks)",
                          lambda: ops.gmm_blocks(x, wt, gs),
                          lambda: gmm_blocks_plain(x, wt, gs),
                          lambda: torch.bmm(xm, wt), 2 * rows * K * N,
                          es * (rows * K + active * K * N + E * C * N),
                          dname, repeat_equal=True,
                          nan_out=((E, C, N), dt), whole=gtag == "full")
                results["gmm_blocks"][f"bwd_{tag}_{gtag}{sfx}"] = {
                    **r, "path": plan.path, "experts_read": active}
            # dw: (tag, d_in of x, d_out of dy): x (E,C,K), dy (E,C,N);
            # under the routed sizes once more with the rows past each
            # group NaN (the kernel must never read them into a sum)
            nans = (False, True) if gtag == "routed" else (False,)
            for (tag, K, N), nan_past in [(t, f) for t in (
                    ("dwg", d, ff), ("dwd", ff, d)) for f in nans]:
                x = rand(E, C, K, dtype=dt)
                dy = rand(E, C, N, dtype=dt)
                zero = torch.zeros((), dtype=dt, device=dev)
                xm, dym = torch.where(keep, x, zero), torch.where(keep, dy,
                                                                  zero)
                if nan_past:
                    nan = torch.full((), float("nan"), dtype=dt, device=dev)
                    x, dy = torch.where(keep, x, nan), torch.where(keep, dy,
                                                                   nan)
                plan = plan_gmm_dw(K, N, C, E, dt)
                ntag = f"bwd_{tag}_{gtag}{'_nan' if nan_past else ''}{sfx}"
                r = check(f"gmm_blocks_dw {ntag} ({E},{C},{K})^T x ({E},{C},"
                          f"{N}) {dname}, {rows} rows in {active} experts"
                          f"{', rows past the groups NaN' if nan_past else ''}"
                          f", {plan.path} path {plan.bm}x{plan.bn} split "
                          f"{plan.split} ({plan.blocks} blocks)",
                          lambda: ops.gmm_blocks_dw(x, dy, gs),
                          lambda: gmm_blocks_dw_plain(x, dy, gs),
                          lambda: torch.bmm(xm.transpose(1, 2), dym),
                          2 * rows * K * N,
                          es * (rows * K + rows * N + E * K * N), dname,
                          repeat_equal=True, nan_out=((E, K, N), dt),
                          whole=gtag == "full")
                results.setdefault("gmm_blocks_dw", {})[ntag] = {
                    **r, "path": plan.path}
        del x, w, wt, xm, dy, dym
        torch.cuda.empty_cache()
    # gmm_blocks_dw at ragged shapes, an empty, a partial and a full
    # expert with the rows past them NaN: d and n off TMA's 16-byte grid
    # take the bf16 tile path with x read M-major in place (f32: its one
    # route); d 200 and n 72 on the grid take the TMA kernel with boxes
    # partly and wholly past d and n, fewer tiles than SMs and an expert
    # that loads nothing
    E, C = 3, 40
    gs_np = np.array([0, 17, 40])
    gs = torch.from_numpy(gs_np.astype(np.int32)).to(dev)
    keep = (torch.arange(C, device=dev)[None, :] < gs[:, None])[..., None]
    rows = int(gs_np.sum())
    for tag, d_in, d_out, dt, route in (
            ("ragged_nan", 20, 9, torch.bfloat16, "tile"),
            ("ragged_nan_f32", 20, 9, torch.float32, "tile"),
            ("ragged_tma_nan", 200, 72, torch.bfloat16, "tma")):
        dname = str(dt).replace("torch.", "")
        nan = torch.full((), float("nan"), dtype=dt, device=dev)
        x = torch.where(keep, rand(E, C, d_in, dtype=dt), nan)
        dy = torch.where(keep, rand(E, C, d_out, dtype=dt), nan)
        plan = plan_gmm_dw(d_in, d_out, C, E, dt)
        if plan.path != route:
            fail(f"gmm_blocks_dw {tag}: planned {plan.path}, this row "
                 f"checks the {route} route")
        r = check(f"gmm_blocks_dw {tag} ({E},{C},{d_in})^T x ({E},{C},"
                  f"{d_out}) {dname}, {rows} rows in 2 experts, rows past "
                  f"the groups NaN, {plan.path} path {plan.bm}x{plan.bn} "
                  f"split {plan.split} ({plan.blocks} blocks)",
                  lambda: ops.gmm_blocks_dw(x, dy, gs),
                  lambda: gmm_blocks_dw_plain(x, dy, gs), None,
                  2 * rows * d_in * d_out,
                  x.element_size() * (rows * (d_in + d_out)
                                      + E * d_in * d_out), dname,
                  repeat_equal=True, nan_out=((E, d_in, d_out), dt),
                  whole=False)
        results["gmm_blocks_dw"][tag] = {**r, "path": plan.path}
    del x, dy

    print("kernels vs plain versions (ssd_scan: mamba2-2.7b at S 1024 in "
          "bf16 from a zero and a random state, in f32, at B 4, and at S 512 "
          "from a random state; zamba2-2.7b's N 64; y and the final state; "
          "a ragged shape; the Pallas sweep):")
    # (tag, B, S, H, P, N, Q, dtype, init state)
    ssd_rows = [
        ("mamba2_S1024", 1, 1024, 80, 64, 128, 256, torch.bfloat16, False),
        ("mamba2_S1024_init", 1, 1024, 80, 64, 128, 256, torch.bfloat16,
         True),
        ("mamba2_S1024_f32", 1, 1024, 80, 64, 128, 256, torch.float32,
         False),
        ("zamba2_S1024_N64", 1, 1024, 80, 64, 64, 256, torch.bfloat16, False),
        ("mamba2_B4_S1024", 4, 1024, 80, 64, 128, 256, torch.bfloat16, False),
        ("mamba2_S512_init", 1, 512, 80, 64, 128, 256, torch.bfloat16, True),
        ("ragged_P60_N100_Q96", 2, 192, 3, 60, 100, 96, torch.float32, True),
        ("ragged_P60_N100_Q96_bf16", 2, 192, 3, 60, 100, 96, torch.bfloat16,
         True),
        ("sweep_S256_N32", 2, 256, 4, 64, 32, 64, torch.float32, False),
        ("sweep_S128_N16", 2, 128, 2, 32, 16, 32, torch.float32, False),
        ("sweep_S192_N64", 2, 192, 4, 64, 64, 64, torch.float32, True)]
    for tag, B, S, H, P, N, Q, dt, init in ssd_rows:
        x = rand(B, S, H, P, dtype=dt, scale=0.3)
        sdt = (torch.from_numpy(np.abs(rng.standard_normal(
            (B, S, H))).astype(np.float32)) * 0.3).to(dev)
        A = -torch.linspace(0.5, 2.0, H, device=dev)
        Bm, Cm = rand(B, S, N, dtype=dt, scale=0.3), rand(B, S, N, dtype=dt,
                                                         scale=0.3)
        D = torch.ones(H, device=dev)
        st = rand(B, H, P, N, scale=0.3) if init else None
        dname, es = str(dt).replace("torch.", ""), x.element_size()
        # operations the function needs over each chunk's lower triangle:
        # C·B^T on Q(Q+1)/2 pairs once per (b, chunk), since every head
        # shares B and C (G = 1); per head its product with x on those
        # pairs, C·state and the state update on Q x N x P; bounded at the
        # peak of x's type (bf16: the tensor cores)
        nc, pairs = S // Q, Q * (Q + 1) // 2
        flops = (2 * B * nc * pairs * N
                 + 2 * B * H * nc * (pairs * P + 2 * Q * N * P))
        nbytes = (es * (2 * B * S * H * P + 2 * B * S * N)
                  + 4 * (B * S * H + 2 * H) + 4 * B * H * P * N * (1 + init))
        plan = plan_ssd(B, S, H, P, N, Q, dt)
        r = check(f"ssd_scan {tag} B={B} S={S} H={H} P={P} N={N} Q={Q} "
                  f"{dname} init_state={init}, blocks of the four phases "
                  f"{plan.blocks}",
                  lambda: ops.ssd_scan(x, sdt, A, Bm, Cm, D, chunk=Q,
                                       init_state=st),
                  lambda: ssd_scan_plain(x, sdt, A, Bm, Cm, D, chunk=Q,
                                         init_state=st),
                  None, flops, nbytes, dname, repeat_equal=True)
        results.setdefault("ssd_scan", {})[tag] = {**r,
                                                   "blocks": plan.blocks}

    print("kernels vs plain versions (ssd_scan_bwd, the backward of the scan: "
          "mamba2-2.7b's training microbatch (B 4, S 512, two chunks) in "
          "bf16 and f32, zamba2-2.7b's (N 64) in bf16, mamba2 at S 1024 "
          "from a random state under a nonzero gradient of the final state, "
          "a ragged bf16 shape (35 heads, P 48, N 96, Q 200) and a ragged "
          "one in bf16 and f32 (a 320-token chunk, P 40, N 72); the "
          "forward's cum, CB and chunk-entry states from the kernels; the "
          "seven gradients each held to the plain backward's; each row's "
          "plan_ssd_bwd plan and each launch's device time; the bound "
          "counts the products over each chunk's lower triangle at x's "
          "type's peak; library: none, no one PyTorch call computes it):")
    t_rows, t_split = time.perf_counter(), 0.0
    for tag, B, S, H, P, N, Q, dt, init in [
            ("mamba2_mb", 4, 512, 80, 64, 128, 256, torch.bfloat16, False),
            ("mamba2_mb_f32", 4, 512, 80, 64, 128, 256, torch.float32,
             False),
            ("zamba2_mb_N64", 4, 512, 80, 64, 64, 256, torch.bfloat16,
             False),
            ("mamba2_S1024_init_dfinal", 1, 1024, 80, 64, 128, 256,
             torch.bfloat16, True),
            ("ragged_H35_P48_N96_Q200", 1, 400, 35, 48, 96, 200,
             torch.bfloat16, True),
            ("ragged_Q320_P40_N72", 1, 640, 6, 40, 72, 320, torch.bfloat16,
             False),
            ("ragged_Q320_P40_N72_f32", 1, 640, 6, 40, 72, 320,
             torch.float32, False)]:
        x = rand(B, S, H, P, dtype=dt, scale=0.3)
        sdt = (torch.from_numpy(np.abs(rng.standard_normal(
            (B, S, H))).astype(np.float32)) * 0.3).to(dev)
        A = -torch.linspace(0.5, 2.0, H, device=dev)
        Bm, Cm = rand(B, S, N, dtype=dt, scale=0.3), rand(B, S, N, dtype=dt,
                                                         scale=0.3)
        D = rand(H)
        st = rand(B, H, P, N, scale=0.3) if init else None
        dy = rand(B, S, H, P, dtype=dt)
        dfin = rand(B, H, P, N) if init else None
        _, _, (cum, cb, ins) = ssd_forward(x, sdt, A, Bm, Cm, D, Q, st, True)
        dname, es = str(dt).replace("torch.", ""), x.element_size()
        # the products: d in_c, 4' off the diagonal and 2' (two) on Q x N x
        # P per head and chunk, dy_i.x_j and the dx product on the lower
        # triangle's pairs, dC and dB from dCB on the pairs x N once per
        # (b, chunk); the bytes: each input read once (CB's lower triangle),
        # each output written once
        nc, pairs = S // Q, Q * (Q + 1) // 2
        flops = (2 * B * nc * H * (4 * Q * N * P + 2 * pairs * P)
                 + 4 * B * nc * pairs * N)
        nbytes = (es * (3 * B * S * H * P + 4 * B * S * N)
                  + 4 * (3 * B * S * H + 4 * H + B * nc * pairs)
                  + 4 * B * nc * H * N * P
                  + 4 * B * H * P * N * (1 + int(init)))
        bplan = plan_ssd_bwd(B, S, H, P, N, Q, dt)
        r = check(f"ssd_scan_bwd {tag} B={B} S={S} H={H} P={P} N={N} Q={Q} "
                  f"{dname} init_state={init} d_final={init} (five launches: "
                  f"din, pass, chunk, bc, scan; {bplan.heads} heads a chunk "
                  f"block in {bplan.groups} groups, blocks {bplan.blocks}, "
                  f"{bplan.smem} B of shared memory, {bplan.scratch} B of "
                  f"scratch)",
                  lambda: ops.ssd_scan_bwd(x, sdt, A, Bm, Cm, D, cum, cb,
                                           ins, dy, dfin),
                  lambda: ssd_scan_bwd_plain(x, sdt, A, Bm, Cm, D, cum, cb,
                                             ins, dy, dfin),
                  None, flops, nbytes, dname, repeat_equal=True,
                  nan_out=[((B, S, H, P), dt), ((B, S, H), torch.float32),
                           ((H,), torch.float32), ((B, S, N), dt),
                           ((B, S, N), dt), ((H,), torch.float32),
                           ((B, H, P, N), torch.float32)])
        t0 = time.perf_counter()
        split = launch_split(lambda: ops.ssd_scan_bwd(
            x, sdt, A, Bm, Cm, D, cum, cb, ins, dy, dfin))
        t_split += time.perf_counter() - t0
        print(f"    device ms a launch: "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
        results.setdefault("ssd_scan_bwd", {})[tag] = {
            **r, "heads": bplan.heads, "launch_ms": split}
        del x, sdt, Bm, Cm, dy, cum, cb, ins
    print(f"  [ssd_scan_bwd rows: {time.perf_counter() - t_rows:.1f} s, of "
          f"which the launch splits {t_split:.1f} s]")
    t0 = time.perf_counter()
    arch_rows()
    print(f"  [archs kernel rows: {time.perf_counter() - t0:.1f} s]")
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print(f"  [kernel phases done at {time.perf_counter() - t_start:.1f} s]")
    if "--kernels-only" in sys.argv[1:]:
        print("chip_smoke: --kernels-only: stopped after the kernel checks")
        sys.exit(0)
    launches = {}

    # -- 4. the main path ---------------------------------------------------
    layers, x_np = build_cnn("resnet50", image=224, width=1.0, classes=100,
                             seed=0)

    def plain_forward(x_in, head=None):
        """All-plain forward: cuDNN convs (TF32 off) and a plain head,
        ``head(y, layer)`` where given."""
        y = torch.from_numpy(x_in).to(dev)
        direct = ConvDirect()
        for l in layers:
            if l.spec.op_type == "stateless":
                y = l.fn(y)
                continue
            w = {k: torch.from_numpy(v).to(dev) for k, v in l.weights.items()}
            if l.spec.op_type == "conv2d":
                y = direct.execute(w, y, l.spec)
            elif head is not None:
                y = head(y, l)
            else:
                y = matmul_plain(y, w["w"]) + w["b"]
        torch.cuda.synchronize()
        return y

    ref_out = plain_forward(x_np)

    def check_output(label, out, ref=ref_out):
        out = out.detach()
        if tuple(out.shape) != (1, 100) or not torch.isfinite(out).all():
            fail(f"{label}: output shape {tuple(out.shape)} or non-finite")
        rel = ((out - ref).abs().max().item()
               / max(ref.abs().max().item(), 1e-30))
        print(f"  {label}: output (1, 100), max|d|/max|ref| = {rel:.3e}")
        if rel > PATH_TOL:
            fail(f"{label}: output disagrees with the all-plain forward "
                 f"({rel:.3e} > {PATH_TOL})")

    print("main path: resnet50 image=224 width=1.0, store_fmt=super")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        eng = ColdEngine(layers, Path(tmp) / "store", store_fmt="super",
                         device="cuda")
        t0 = time.perf_counter()
        stats = eng.decide(x_np)
        print(f"  decide: {time.perf_counter() - t0:.2f} s, "
              f"profile_calls={stats['profile_calls']} "
              f"shape_classes={stats['shape_classes']} "
              f"io_interference={stats['io_interference']:.3f} "
              f"est_makespan_s={stats['est_makespan_s']:.6f}")
        if stats.get("degraded"):
            fail(f"decide degraded: {stats.get('error')}")
        weighted = [l for l in layers if l.spec.weight_shapes]
        choices = {l.spec.name: stats["choices"][l.spec.name]
                   for l in weighted}
        summary = {}
        for kern, cached in choices.values():
            key = f"{kern}/{'cache' if cached else 'raw'}"
            summary[key] = summary.get(key, 0) + 1
        print(f"  plan summary: {json.dumps(summary)}")
        print(f"  plan: {json.dumps(choices)}")

        def pinned(conv_s1, conv_s2, head):
            out = []
            for l in layers:
                if l.spec.op_type == "stateless":
                    out.append(Choice("fn", False))
                elif l.spec.op_type == "linear":
                    out.append(Choice(head, False))
                else:
                    s = l.spec.config.get("stride", 1)
                    out.append(Choice(conv_s1 if s == 1 else conv_s2, False))
            return out

        runs = [("decided plan", None),
                ("pinned winograd+packed",
                 pinned("winograd_f2x3", "im2col_sgemm", "packed")),
                ("pinned im2col+direct",
                 pinned("im2col_sgemm", "im2col_sgemm", "direct"))]
        decided = eng.plan
        per_run = []
        # the Winograd GEMM shapes of each run, for their time a forward
        wino_calls = {}
        wino_kernel = ops.winograd_tile_matmul

        def wino_recording(V, U):
            wino_calls.setdefault(label, []).append(
                (tuple(V.shape), tuple(U.shape)))
            return wino_kernel(V, U)

        ops.winograd_tile_matmul = wino_recording
        ops.reset_launch_counts()
        for label, pin in runs:
            before = ops.launch_counts()
            if pin is not None:
                eng.set_plan(replace(decided, choices=pin))
            start = (decided_arm_state(eng, "nnv12", "")
                     if pin is None else AS_LEFT)
            r = eng.run_cold(x_np)
            after = ops.launch_counts()
            delta = {k: after[k] - before[k] for k in after}
            per_run.append((label, delta))
            print(f"  run_cold [{label}; start: {start}]: "
                  f"total_s={r.total_s:.4f} "
                  f"stage_seconds={json.dumps(r.stage_seconds())} "
                  f"launches={json.dumps(delta)}")
            check_output(label, r.output)
        ops.winograd_tile_matmul = wino_kernel
        cnn_counts = ops.launch_counts()
        for k in ("matmul", "matmul_packed", "winograd_tile_matmul"):
            launches[k] = cnn_counts[k]
        # the Winograd GEMMs of one pinned-Winograd forward: device time of
        # the kernel and of torch.bmm at each shape (CUDA-graph replay),
        # summed over the forward's calls (after the counted runs)
        calls = wino_calls.get("pinned winograd+packed", [])
        t_k = t_b = 0.0
        for shape in sorted(set(calls)):
            n = calls.count(shape)
            V, U = rand(*shape[0]), rand(*shape[1])
            dk = device_ms(lambda: ops.winograd_tile_matmul(V, U))
            db = device_ms(lambda: torch.bmm(V, U), library=True)
            t_k += n * dk
            t_b += n * (db or 0.0)
            print(f"  Winograd GEMM {shape[0]}x{shape[1]} x{n}: device "
                  f"{dk:.4f} ms, torch.bmm {db if db is None else round(db, 4)}"
                  f" ms")
        print(f"  resnet50 pinned winograd+packed forward: {len(calls)} "
              f"Winograd GEMMs, {t_k:.4f} ms of kernel device time "
              f"(torch.bmm {t_b:.4f} ms)")
        repairs = eng.repairs.counts()
        open_breakers = eng.breaker.open_keys()
        print(f"  repairs={json.dumps(repairs)} open_breakers={open_breakers}")
        if repairs.get("kernel_demoted") or open_breakers:
            fail(f"kernels were demoted on the main path: {repairs} "
                 f"{open_breakers}")
        for k, n in launches.items():
            if n <= 0:
                fail(f"kernel {k} never launched on the CNN path")
        # the other entry points of the slice, outside the counted window
        eng.set_plan(decided)
        for label, mode, audit in [("decided plan", "nnv12_nosteal", ""),
                                   *DECIDED_ARMS[1:]]:
            start = decided_arm_state(eng, mode, audit)
            r = eng.run_cold(x_np, mode=mode)
            print(f"  run_cold [{label}, {mode}; start: {start}]: "
                  f"total_s={r.total_s:.4f}")
            check_output(f"{label} {mode}", r.output)
        print(f"  run_warm: {eng.run_warm(x_np):.4f} s")
        # staging through the pinned-slab DMA thread against inline host
        # staging, on the pinned Winograd plan, alternated
        host_stage = StageEngine("host")
        host_eng = ColdEngine(layers, Path(tmp) / "store_host",
                              store_fmt="super", device="cuda",
                              stage_engine=host_stage)
        host_eng.ensure_plan(x_np)
        wino = replace(decided, choices=runs[1][1])
        eng.set_plan(wino)
        host_eng.set_plan(wino)
        for label, e in (("dma", eng), ("host", host_eng),
                         ("dma", eng), ("host", host_eng)):
            r = e.run_cold(x_np)
            print(f"  run_cold [pinned winograd+packed, stage engine {label}]:"
                  f" total_s={r.total_s:.4f} "
                  f"stage_seconds={json.dumps(r.stage_seconds())}")
            check_output(f"stage engine {label}", r.output)
        for e in (eng, host_eng):
            if e.repairs.counts().get("kernel_demoted"):
                fail(f"kernels were demoted: {e.repairs.counts()}")
        host_stage.close()

        # the lossy CNN path: the head on the int8, int4 and bf16 caches
        print("lossy CNN path: resnet50 image=224 width=1.0, allow_lossy=True,"
              " store_fmt=super")
        leng = ColdEngine(layers, Path(tmp) / "store_lossy",
                          store_fmt="super", allow_lossy=True, device="cuda")
        leng.profiler_factory = SyntheticProfiler
        t0 = time.perf_counter()
        stats = leng.decide(x_np, calibrate_interference=False)
        print(f"  decide (SyntheticProfiler): {time.perf_counter() - t0:.2f}"
              f" s, profile_calls={stats['profile_calls']} "
              f"shape_classes={stats['shape_classes']}")
        if stats.get("degraded"):
            fail(f"decide degraded: {stats.get('error')}")
        print(f"  plan summary: "
              f"{json.dumps(plan_summary(stats['choices'].values()))}")
        head = next(l for l in layers if l.spec.op_type == "linear")
        print(f"  plan for the head: {json.dumps(stats['choices'][head.spec.name])}")
        for kernel in ("int8", "int4", "bf16"):
            materialize(leng, head, kernel)
        leng.store.maintain()

        def lossy_head(kernel):
            w = layer_weights(leng, head, kernel, True, dev)
            if kernel == "bf16":  # bf16 operands, f32 accumulation
                return lambda y, l: matmul_plain(
                    y.to(torch.bfloat16), w["w"], torch.float32) + w["b"]
            return lambda y, l: matmul_plain(y, w["w"]) + w["b"]

        # the head's kernel for each arm: one launch a run, and none of the
        # other arms' kernels
        head_kernels = {"int8": "matmul_dequant_int8",
                        "int4": "matmul_dequant_int4", "bf16": "matmul_bf16"}
        ops.reset_launch_counts()
        for kernel in ("int8", "int4", "bf16"):
            pin = [Choice(kernel, True) if l.spec.op_type == "linear" else c
                   for l, c in zip(layers, pinned("im2col_sgemm",
                                                  "im2col_sgemm", "direct"))]
            leng.set_plan(replace(leng.plan, choices=pin))
            before = ops.launch_counts()
            r = leng.run_cold(x_np)
            after = ops.launch_counts()
            delta = {k: after[k] - before[k] for k in after
                     if after[k] - before[k]}
            print(f"  run_cold [head {kernel} cached, im2col convs]: "
                  f"total_s={r.total_s:.4f} "
                  f"stage_seconds={json.dumps(r.stage_seconds())} "
                  f"launches={json.dumps(delta)} cache bytes of the head "
                  f"{leng.store.cached_bytes(head.spec.name, kernel)}")
            check_output(f"lossy head {kernel}", r.output,
                         plain_forward(x_np, lossy_head(kernel)))
            for arm, k in head_kernels.items():
                want = 1 if arm == kernel else 0
                if delta.get(k, 0) != want:
                    fail(f"lossy head {kernel}: {k} launched "
                         f"{delta.get(k, 0)} times in the run, expected "
                         f"{want}")
        lossy_counts = ops.launch_counts()
        for k in ("matmul_dequant_int8", "matmul_dequant_int4"):
            launches[k] = lossy_counts[k]
            if lossy_counts[k] <= 0:
                fail(f"kernel {k} never launched on the lossy CNN path")
        if leng.repairs.counts().get("kernel_demoted") \
                or leng.breaker.open_keys():
            fail(f"kernels were demoted: {leng.repairs.counts()}")

        # -- 4a. continuous mode: kernel switching ---------------------------
        for k, n in switching_path(card, eng, layers, x_np, decided,
                                   runs[2][1], check_output).items():
            launches[k] += n
        if eng.repairs.counts().get("kernel_demoted") \
                or eng.breaker.open_keys():
            fail(f"kernels were demoted: {eng.repairs.counts()}")
    reset_io_engine()
    reset_stage_engine()
    reset_core_pool()
    print(f"  [CNN path done at {time.perf_counter() - t_start:.1f} s]")

    # -- 4b. the front-door fleet with peer warm-state transfer --------------
    for k, n in fleet_path(card, x_np, ref_out, check_output).items():
        launches[k] += n
    print(f"  [fleet path done at {time.perf_counter() - t_start:.1f} s]")

    # -- 5. the cold-LLM path -----------------------------------------------
    launches.update(llm_path(dev, LLM_DEPTH))
    print(f"  [LLM path done at {time.perf_counter() - t_start:.1f} s]")
    launches.update(llm_lossy_path(dev, LOSSY_DEPTH))
    print(f"  [lossy LLM path done at {time.perf_counter() - t_start:.1f} s]")

    # -- 6. the serving path -------------------------------------------------
    launches.update(serving_path(dev, SERVE_DEPTH))
    print(f"  [serving path done at {time.perf_counter() - t_start:.1f} s]")

    # -- 7. the moe and ssm families ------------------------------------------
    # the f32 matmul's launches sum the CNN path's, granite's router and
    # mamba2's f32 runs
    for family, path, depth in (("moe", moe_path, MOE_DEPTH),
                                ("ssm", ssm_path, SSM_DEPTH)):
        counts = path(dev, depth)
        launches["matmul"] += counts.pop("matmul")
        launches.update(counts)
        torch.cuda.empty_cache()
        print(f"  [{family} path done at "
              f"{time.perf_counter() - t_start:.1f} s]")

    # -- 7b. the hybrid family; the embeddings and vlm input modes ----------
    for family, run in (
            ("hybrid", lambda: hybrid_path(dev, HYBRID_DEPTH,
                                           HYBRID_F32_DEPTH)),
            ("input-modes", lambda: modes_path(dev, MUSICGEN_DECODE,
                                               VLM_DEPTH)),
            ("archs", lambda: archs_path(dev))):
        for k, n in run().items():
            launches[k] = launches.get(k, 0) + n
        torch.cuda.empty_cache()
        print(f"  [{family} path done at "
              f"{time.perf_counter() - t_start:.1f} s]")

    # -- 7c. training: the dense body -----------------------------------------
    for k, n in training_path(dev, card, TRAIN_F32_DEPTH).items():
        launches[k] = launches.get(k, 0) + n
    torch.cuda.empty_cache()
    print(f"  [training path done at {time.perf_counter() - t_start:.1f} s]")

    # -- 7d. training: the moe family -----------------------------------------
    for k, n in moe_training_path(dev, card, MOE_TRAIN_F32_DEPTH,
                                  MOE_TRAIN_DEPTH).items():
        launches[k] = launches.get(k, 0) + n
    torch.cuda.empty_cache()
    print(f"  [moe training path done at "
          f"{time.perf_counter() - t_start:.1f} s]")

    # -- 7e. training: the ssm and hybrid families ----------------------------
    for k, n in ssm_training_path(dev, card).items():
        launches[k] = launches.get(k, 0) + n
    torch.cuda.empty_cache()
    print(f"  [ssm training path done at "
          f"{time.perf_counter() - t_start:.1f} s]")

    # -- 7f. the roofline report: a prefill step counted on the card --------
    for k, n in roofline_path(dev, card).items():
        launches[k] = launches.get(k, 0) + n
    torch.cuda.empty_cache()
    print(f"  [roofline path done at {time.perf_counter() - t_start:.1f} s]")

    # -- 8. report ----------------------------------------------------------
    main_shape = {"winograd_tile_matmul": "stage0", "matmul": "im2col_s1b0",
                  "matmul_packed": "head", "matmul_bf16": "head",
                  "flash_attention": "prefill64",
                  "flash_attention_bwd": "smollm_mb",
                  "decode_attention": "B1_W82_bfloat16",
                  "dequant_int8": "head",
                  "dequant_int4": "head",
                  "matmul_dequant_int8": "resnet_head",
                  "matmul_dequant_int4": "resnet_head",
                  "gmm_blocks": "decode_gate",
                  "gmm_blocks_dw": "bwd_dwg_routed",
                  "ssd_scan": "mamba2_S1024",
                  "ssd_scan_bwd": "mamba2_mb"}
    out = []
    for k, (source, replaces) in ops.KERNELS.items():
        r = results[k][main_shape[k]]
        out.append({"name": k, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches[k],
                    "shape": main_shape[k], **r})
    print(f"kernels: " + ", ".join(f"{k}={n}" for k, n in launches.items()))
    print(card)  # again near the end, where a clipped log still shows it
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
