#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``repro_torch``'s main path — the all-to-all encode — once on the
card, at a width its users would call real, and checks everything it
computes. It imports ``repro_torch`` only (never JAX, never the JAX package).
Phases, each printing one JSON line; any failure ends the run non-zero:

1. ``env``      torch/CUDA versions, the card's name and power limit, the
                host's memory (``MemTotal``).
2. ``build``    builds the CUDA kernels from ``src/repro_torch/csrc`` with nvcc.
3. ``kernels``  each kernel against its plain PyTorch version on the card,
                bit for bit (tolerance 0: the arithmetic is exact mod q), over
                ragged, tiny and extreme-valued shapes and at every shape
                that phases 4, 6-14 and 16-18 hand it, as they hand it, with its
                time, its wrapper's host time, its plain version's time, its
                bound and its share of the bound at each of those. A
                kernel's time is that of 30 back-to-back launches between
                one pair of CUDA events, over 30, each launch with its checks
                and output made beforehand (``*_launcher``); where one call
                moves under 100 MB the launches rotate over copies of its
                inputs that pass 100 MB (2x the L2), as the caller finds them
                cold. ``host_us`` is one call of the wrapper, enqueue only.
                ``gf_matmul`` is held at every M from 1 to 17, K in 1..9 and
                33, N % 4 in {0, 1, 2, 3}, with A, B and C at 4-, 8- and
                12-byte offsets, on all-(q-1) operands at every row tile,
                and at a batch of 65,537, so that every row tile of the row
                kernel and the general kernel each run in their aligned and
                their ragged form, or the run fails; each main-path shape's
                record names the row tile and the form it gets. The coded
                entry points run in column blocks of ``block_columns(rows)``
                (``coded.rs_checkpoint``, a block's working set within
                ``BLOCK_BYTES``): phase 3 holds each block shape
                they give a kernel, the last, ragged block's too.
                ``butterfly_mac`` (the row form: parts read through a row
                table, or one source a slot) is held at every pair of source
                and output 16-byte
                phases, rows of head or tail alone, gathered, repeated and
                identity rows, radix 1 to 8 and the cap of 64, a batch of
                65,537 and offsets past 2^31 elements, and the run fails
                unless the cases reached every path. A 1 GiB device ``copy_`` gives the bytes/s
                the card's memory attains, the yardstick of "near the bound".
4. ``universal`` (K=64, M31), ``dft`` (K=64, NTT), ``draw_loose`` (K=48, NTT),
                each with 2^20 payload elements a processor, through
                ``a2a_encode`` and through ``ir_encode(kernels="cuda")``: both
                equal, equal to a plain ``x @ A mod q`` on the card and to the
                host oracle on sampled columns, decodes invert, the kernels'
                launch counters and the executor's permutation counter hold
                the expected numbers. Then the topology-aligned encodes at K=64
                and 2^20 elements, each through its own entry point:
                ``hierarchical`` (``hierarchical_encode(A, k_intra=8)``, M31),
                ``multilevel`` (``multilevel_encode(A, (4, 4, 4))``, M31),
                ``pipelined`` (``ps_encode(A, pipeline="pipeline")``, M31, the
                universal A) and ``two_level_dft`` (``ir_encode`` of
                ``plan_two_level_dft(64, 1, NTT, 8)``), with the same checks
                and the permutation count equal to the budget function. Then
                each encode's median wall time and, under ``torch.profiler``,
                its device-busy time, idle share, time by kind of kernel,
                busiest device kernels by name and the kind of kernel that
                runs just before each ``butterfly_mac`` (none may be a gather
                or a copy on ``dft`` and ``draw_loose``'s ``a2a_encode`` and
                on ``lcc_square``); ``pipelined`` is also timed
                beside the same IR with its overlap LocalOps run in order.
5. ``traced``   ``multilevel`` through ``ir_encode(tracer=Tracer(),
                topo=Hierarchy(levels=(4, 4, 4)))`` twice: bit-equal to the
                untraced encode, one root span and one span a round (levels
                0,0,1,1,2,2), permutations and registry counters as budgeted;
                then the calibration feed into a temporary file, its fitted
                α/β and drift rows (one card's gathers in HBM, not links).
6. ``coded``    the coded layer at the widths of Qwen3-1.7B
                (``src/repro/configs/qwen3_1_7b.py``), with its own launch
                counts: ``coded_checkpoint`` (``CodedStateGuard(K=16)``, M31,
                over one decoder layer's bf16 parameters with float32 Adam
                moments, an int32 step and a bool mask: parity through
                ``encode_parity`` and ``encode_parity_collective`` flat and
                with sizes (4, 4), all bit-equal, equal to a plain ``x @ A
                mod q`` on the card and to the host oracle on sampled columns;
                then ``fail_and_recover`` of replicas 1, 4, 6 bit for bit),
                ``lcc_serve`` (``CodedServeGuard(K=6, R=2)``, NTT, over the bf16
                KV cache of all 28 layers for 4 slots x 1,024 positions plus
                token and position leaves: snapshot, two scheduled kills,
                recover bit for bit, with ``collective=False`` and ``True``
                giving bit-equal coded shards), ``lcc_square``
                (``lcc_encode(build_lcc(48), X)``, the draw-and-loose Lagrange
                encode of the same cache cut to 4 layers (its host decode
                took 91 s at 28) in 48 shards, equal to a plain
                ``X @ G mod q``, and ``lcc_decode`` from all 48 back to X) and
                ``grad_coding`` (``worker_combine``/``aggregate``, K = 8,
                s = 2, over one layer's float32 gradients on the card against
                the CPU at rtol 1e-6). Each with its wall ms, the device
                bytes each entry point holds as it starts and at its peak
                (read as it returns, before any check), busy time and idle
                share, and host numpy ms of the recovery. Every encode here
                runs in column blocks, and its launches follow the blocks.
7. ``serve``    the serving path at the full width of Qwen3-1.7B (14 of its 28
                layers, cut for the script's time; d_model 2048, 16 heads x
                128, 8 KV heads, d_ff 6144, vocab 151,936, bf16 weights drawn
                on the card from the seed):
                ``ContinuousEngine`` with 4 slots, max_len 1024, buckets (128,
                256, 512), 32 new tokens at most, over a seeded Poisson trace
                of 12 requests with prompts of 16-512 tokens: (a) greedy; (b)
                greedy under ``CodedServeGuard(K=6, R=2)`` with one scheduled
                kill, its tokens equal to (a)'s; (c) sampled at temperature
                1.0 under the guard with one kill, equal to the same sampled
                run unfailed; (d) the guard's ``collective=True`` form, equal
                to (a); (e) the fixed-batch ``Engine`` on 4 prompts; (f)
                ``prefill_into_cache`` against the per-token refeed through
                ``decode_step`` at a stated bf16 tolerance; (g) the float32
                smoke config on the card against the CPU. Every ``gf_matmul``
                shape the guard hands the kernel (the engine state's own shard
                width) is among phase 3's. Prints tokens/s, TTFT and e2e
                p50/p99, each snapshot's and the recovery's ms (with the host
                numpy inside it), prefill ms per bucket, one decode tick's ms,
                the idle share of a profiled decode chunk, the launches, the
                peak device bytes and those of ``Model.init``.
8. ``train``    training of Qwen3-1.7B, with its own launch counts: (a) six
                steps of ``launch.train.main`` at full width and depth (28
                layers, bf16 weights drawn on the card from the seed, float32
                AdamW moments, ``remat="block"``, batch 8 x 256 synthetic
                tokens, the launcher's defaults), with ``--coded-every 5``:
                one ``CodedStateGuard(K=8)`` snapshot of the whole 17.2 GB
                state after the last step, encoded in column blocks into
                68.8 GB of host copies; the snapshot's wall, its copies to
                the host, its added device bytes (at most 2 GiB) and the
                steps' peak before it; every 16th block of the guard's limbs
                and the last against the returned state's, built again on
                the card, and
                the parity of the first, the ragged last, a leaf boundary's
                and four random blocks against a plain ``x @ A mod q`` on the
                card and the host oracle on sampled columns; each step's loss
                and grad norm, the median step wall, tokens/s, peak device
                bytes, the state's bytes, and one step and one
                ``apply_updates`` under the profiler (busy, idle share, ms by
                kind); (b) the float32 smoke config, three steps
                on the card against the CPU from the same parameters and
                batches, within stated tolerances; (c) the resume of the
                reference's system test at its own cut
                (``smoke_config("qwen3-1.7b").replace(n_layers=1)``): six
                steps uninterrupted against three, ``CodedStateGuard(K=8)``
                snapshot, ``fail_and_recover([1, 4, 6])`` and three more, and
                against a disk checkpoint restored into three more, all bit
                for bit, with the snapshot's ``gf_matmul`` shape among phase
                3's.
9. ``ranks``    the encode as messages between processes: K spawned ranks
                share the card (each on ``cuda:0``, a gloo group, port groups
                staged through pinned host memory) and run the entry points of
                ``repro_torch.dist.ranks`` on their own blocks, inputs from the
                seed with numpy: at K = 8 and 2^20 elements a processor
                ``ps_encode_ranks`` p = 1 and 2 (M31), ``butterfly_ranks``
                forward then inverse (NTT), ``hierarchical_encode_ranks`` 4 × 2,
                ``multilevel_encode_ranks`` 2 × 2 × 2, ``ps_encode_ranks`` with
                ``pipeline="pipeline"`` and ``allgather_encode_ranks``; at the
                coded cells' widths ``lcc_encode_ranks`` (N = 8: K = 6, R = 2,
                39,148,204 limbs a shard) and, on a second pool of 16 ranks,
                ``ps_encode_ranks`` at K = 16 and ``encode_parity_ranks`` flat
                and (4, 4) (15,730,001 limbs a replica). Every rank's block
                hashes like its row of the one-card executor's output, itself
                equal to a plain ``x @ A mod q`` on the card; every rank runs
                the budget, on the card, with the hand kernels, whose launches
                the ranks count; each rank's median wall of 3 (after a
                barrier) and, from one traced call, the wire part (round spans)
                and the device part (LocalOp spans). Phase 3 holds and times
                the kernels at the ranks' batch-1 shapes.
10. ``moe``     the MoE family at the full width of Snowflake Arctic
                (``arctic-480b``: d_model 7168, 56 heads, 8 KV heads x 128,
                128 experts top-2 with expert_ff 4864 and a dense residual
                SwiGLU of 4864, vocab 32,000, capacity factor 1.25), cut to 2
                of its 35 layers (one holds 27.2 GB of bf16 weights), drawn on
                the card from the seed after the card is emptied (under 1 GB
                held as it starts), with its own launch counts: the serve
                phase's engine and trace (a) greedy under the baseline rules
                (scatter dispatch), with the (token, slot) pairs capacity
                drops in each prefill; (b) greedy under the ``moe_gather``
                profile's rules, tokens equal to (a)'s, and both forms' logits
                on one 500-token prefill and one tick, equal; (c) greedy under
                ``CodedServeGuard(K=6, R=2)`` with one kill, tokens equal to
                (a)'s, the guard's ``gf_matmul`` shape among phase 3's; (d) the
                float32 smoke config on the card against the CPU: logits of
                ``forward``, ``decode_step`` and ``prefill_into_cache`` within
                1e-4 and every router choice equal. Prints tokens/s, TTFT and
                e2e p50/p99, a tick's ms beside its bytes bound (every weight
                but ``embed`` read once), prefill ms per bucket, the idle
                share of a profiled decode chunk, init and peak bytes, the
                snapshot and recovery ms. (b) also serves with the combine
                ``moe_block`` had before its fixed order (``index_add``):
                the same tokens and logits at top-2.
11. ``mla``     MLA, the layer prefix and MTP at the full width of DeepSeek-V3
                (``deepseek-v3-671b``: d_model 7168, 128 heads, MLA ranks
                1536 / 512, heads 128 + 64 rope, 256 experts top-8 with
                expert_ff 2048 and one shared, dense prefix SwiGLU 18,432,
                vocab 129,280), cut to 4 of its 61 layers (the 3 leading
                dense layers, ``prefix_{i}``, and one MoE layer) with the MTP
                head: 53.4 GB of bf16 weights drawn on the emptied card from
                the seed, with its own launch counts. Phase 10's engine and
                trace: (a) greedy under the baseline rules, with the pairs
                capacity drops in each prefill; (b) greedy under the
                ``moe_gather`` rules, tokens equal to (a)'s, and on one
                500-token prefill and one tick the logits of both forms and
                of the scatter form run again, bit-equal (top-8: the
                combine's fixed order); (c) greedy under
                ``CodedServeGuard(K=6, R=2)`` with one kill, tokens equal to
                (a)'s, the guard's ``gf_matmul`` shape (the MLA cache: latent
                and rope key) among phase 3's; (d) the float32 smoke config
                and its top-8 variant (16 experts) on the card against the
                CPU: logits within 1e-4, router choices equal, ``loss`` with
                ``mtp_ce`` within 1e-5. Prints what phase 10 prints, the
                tick against its bound of every weight but ``embed`` and
                ``mtp`` read once.
12. ``ssm``     the SSM families, each on the emptied card with bf16 weights
                from the seed, counted on their own, every width kept and
                the depth cut: RWKV6-3B at 4 of its 32 layers
                (``rwkv6-3b``: d_model 2560, 40 heads x 64, d_ff 8960, vocab
                65,536; 1.3 GB) and Jamba at 8 of its 32 layers, one whole
                period of 8 (``jamba-v0.1-52b``: d_model 4096, d_inner 8192,
                d_state 16, dt_rank 256, one attention layer a period, 16
                experts top-2 of expert_ff 14,336 on alternate layers, vocab
                65,536; 26.6 GB); each refeed tick is launch-bound, so its
                time goes with the depth. Neither has a one-pass prefill, so
                both serve through the fixed ``Engine``'s per-token refeed,
                max_len 512, the serve trace's first 4 prompts, 32 new
                tokens: (a) greedy twice with one SHA-256 of the tokens
                (Jamba's capacity drops a tick); (b) the same refeed tick by tick through
                ``make_decode_step``, ``CodedServeGuard(K=6, R=2).snapshot``
                of the recurrent cache (Mamba ``h`` and conv tails, RWKV
                ``wkv`` and token-shift rows) with the tokens and position at
                tick 40, four ticks more, host 3 killed, ``poll``,
                ``recover``: the recovered bytes equal the snapshot's and the
                refeed resumed from them gives (a)'s tokens until the
                shortest prompt's request is complete, the guard's
                ``gf_matmul`` shape among phase 3's; (c) one real Mamba and
                one real RWKV layer in float32, the full-sequence scan over 64
                tokens against 64 decode calls, and RWKV6-3B's bf16
                ``forward`` (8 layers) against its refeed at rtol = atol = 0.15; (d) both
                float32 smoke configs on the card against the CPU: logits of
                ``forward`` and 8 ``decode_step``s within 1e-4, router choices
                equal, ``loss`` within 1e-5. Prints tokens/s, the tick's ms
                beside its bound (every weight but ``embed`` read once),
                kernels a tick, the idle share of a profiled chunk of 4 ticks,
                init and peak bytes, the snapshot and recovery ms.
13. ``encdec_vlm`` the encoder-decoder and VLM families, each at full
                width on the emptied card with bf16 weights from the seed,
                counted on their own: Whisper-base (``whisper-base``: 6
                encoder and 6 decoder layers, d_model 512, 8 heads, d_ff 2048,
                1,500 stub frames, vocab 51,865 padded to 51,968; 207 MB) and
                InternVL2-26B (``internvl2-26b``: 6 of its 48 layers,
                d_model 6144, 48/8 heads, d_ff 16,384, 256 stub
                patches, vocab 92,553 padded to 92,672; 7.0 GB; 39.7 GB
                whole). Neither has a one-pass prefill:
                (a) ``launch/serve.py`` with its default engine falls back to
                the fixed ``Engine`` (it must say so) and serves the serve
                trace's first 4 prompts, 32 new tokens, max_len 512, greedy
                (Whisper twice, InternVL2 once; one SHA-256); (b) the same
                refeed tick by tick through ``make_decode_step``,
                ``CodedServeGuard(K=6, R=2).snapshot`` of the cache (K/V
                rows and Whisper's ``enc_out``) with the tokens and position
                at tick 40, four ticks more, host 3 killed, ``poll``,
                ``recover``: the recovered bytes equal the snapshot's and the
                refeed resumed from them gives (a)'s tokens until the
                shortest prompt's request is complete, the guard's
                ``gf_matmul`` shape among phase 3's; (c) Whisper's ``forward``
                over 2 x 64 tokens and 1,500 frames against 64
                ``decode_step``s over their encoding at rtol = atol = 0.2 (the
                reference's oracle), and InternVL2's ``prefill`` of 256
                patches and 256 tokens twice, one hash; (d) both float32
                smoke configs on the card against the CPU (frames and patches
                in the batch): logits of ``forward`` and 8 ``decode_step``s
                within 1e-4, ``loss`` within 1e-5. Prints what phase 12
                prints, the tick's bound counting the weights a tick reads,
                the K/V rows it attends and Whisper's ``enc_out`` once a
                cross layer.
14. ``analysis`` the analysis layer, the examples and ``trace_encode`` on the
                card, with their own launch counts: (a) the four examples
                that compute (``examples/{quickstart,coded_checkpoint_recovery,
                serve_lm,train_lm}_torch.py``) in this process at their own
                sizes (``train_lm`` with ``--steps 2 --fail-at 1
                --coded-every 1``: ~110M parameters, the recovery bit-exact),
                each held to its own asserts and its launches to the calls
                phase 3 held; (b) ``tools/trace_encode_torch.py`` at its
                default payload: one span a round, output equal to the
                untraced encode and the host oracle, both trace files through
                ``tools/check_trace.py``; (c) the roofline shares of phases 7
                and 8's steps, counted on meta tensors at their shapes
                (``launch.op_cost``) and nothing rerun: the train step's
                flops and ``model_flops`` over its median time × 989 TFLOP/s
                (``mfu_*``), its live-bytes peak against the measured one, the
                decode tick's bytes and its least bytes over its time × 3.35
                TB/s; (d) the one-card dry run of all 40 cells
                (``launch.dryrun``, worker processes) and its roofline table,
                within 60 s.
15. ``mesh``     the sharding substrate (DTensor over a ``RankMesh``): one
                spawned world of four ranks on ``cuda:0`` over the port's
                staging backend (``dist.staging``: gloo on pinned host
                copies) runs (a)-(d) while the parent computes the
                one-process references: (a) Qwen3-1.7B at every width, 7 of
                its 28 layers (cut for the script's time; bf16 weights from the seed,
                each rank keeping its shard) served by
                ``ContinuousEngine(mesh=(data 2, model 2))`` under the
                reference's decode preset with its ``opt`` profile, 4 slots,
                max_len 1,024, over the serve trace's first 6 requests and
                (b)'s two prompts, 16 new tokens, greedy: tokens equal on
                every rank; against the one-process engine on the same
                weights, the float32 smoke config's tokens equal and the
                full-width logits of one prefill and one tick within phase
                7's bf16 tolerances (greedy bf16 tokens may part on
                near-ties); a tick's ms, its collectives (``CommDebugMode``)
                and staged bytes; (b) ``launch/serve.py --mesh 2x2 --profile
                opt`` on the two prompts: (a)'s tokens; (c) three float32
                smoke train steps of ``make_train_step(mesh=)`` against the
                CPU's at phase 8's tolerances, then ``launch/train.py --mesh
                2x2`` at full width cut to 1 of 28 layers, 2 steps of 8 x
                256, its checkpoint restored under its shardings and the
                parameters resharded onto a 4 x 1 mesh, bit for bit against
                the file; (d) ``pipeline_apply`` over four Qwen3-1.7B blocks
                (one a rank, axis ``pipe``), 6 microbatches of (2, 256,
                2048), against the blocks in sequence on one rank; (e) beside
                the world, in processes of their own: (a)'s tick counted by
                the dry run (``dist.counting``: the same config, rules, 4
                slots and max_len, on ``meta`` blocks of a fake world of four
                ranks), whose calls and bytes a collective must equal (a)'s
                staged calls and bytes (a call's input and output bytes),
                beside ``CommDebugMode``'s count of the same meta tick; and
                one production-mesh cell (Qwen3-1.7B, ``decode_32k``, 256
                ranks) through ``launch.dryrun``, printed with its wall time.
                The phase holds itself within 150 s; no hand kernel runs in it.
16. ``coded_mesh`` the coded guards on the mesh: one spawned world of four
                ranks on ``cuda:0`` (the staging backend; the guard's host
                axis over a gloo group of the same ranks), checks made by the
                parent: (a) phase ``mesh``'s engine (Qwen3-1.7B, 7 layers, bf16,
                2x2, ``opt`` profile, 4 slots, max_len 1,024) over the serve
                trace's first 4 requests (426, 75, 239, 110 tokens), 12 new
                tokens, greedy, unguarded; (b) the same under
                ``CodedServeGuard(K=2, R=2, mesh=<the four ranks as axis
                "hosts">, axis="hosts")``, host 3 killed after tick 8: tokens
                equal (a)'s on every rank, the first snapshot's four coded
                rows equal rank 0's one-program ``lcc_encode`` of the same
                limbs, each rank's launches one snapshot's calls a snapshot;
                (b') one snapshot by the rank form at p = 3 (one round:
                ``butterfly_mac`` on every rank) of the state (b) leaves, its
                rows equal to the one-program encode;
                (c) ``launch/serve.py --mesh 2x2 --profile opt --coded 3,2
                --kill 2:0 --kill 6:4`` on phase ``mesh``'s two prompts, 8 new
                tokens: the tokens of the same command without ``--coded``;
                (d) ``launch/train.py --mesh 2x2 --smoke --coded-every 1``, 3
                steps: rank 0's shards and parity equal a one-process guard's
                over the gathered state, ``fail_and_recover([1, 4, 6])`` and
                ``reshard_state`` give every rank its blocks bit for bit;
                (d') ``launch/train.py --mesh 2x2 --layers 1 --coded-every 1``
                at full width, 2 steps of 8 x 256: rank 0 gathers the meshed
                state and encodes it in column blocks; its added bytes, and
                the limbs and parity of its first, last and three random
                blocks against the state gathered again and a plain ``x @ A
                mod q`` on the card. Each snapshot's and recovery's ms, each
                rank's held and peak bytes, rank 0's added bytes at each
                snapshot of (c) and (d'); the phase holds itself within 240 s.
                Then a line ``memory``: every blocked entry point's held,
                peak and added bytes (phases 6, 8 and 16) beside its bound
                and its bytes before the blocks (ROADMAP B1); a row over its
                bound fails the run.
17. ``moe_mesh`` the MoE and MLA families on the mesh: the parent serves
                one prefill and one tick of DeepSeek-V3 at full width (bf16, 4
                of 61 layers: the 3 dense MLA prefix layers, one MLA-MoE
                layer, MTP; 53.4 GB) in one process and frees the card; then
                one spawned world of four ranks on ``cuda:0`` (the staging
                backend) under the decode preset's ``opt`` rules, each rank
                drawing only its own blocks of the same seed's weights
                (``Model.init(shardings=)``; ~15 GB a rank, its held bytes
                equal to the specs' reckoning, its draw peak within 1 GiB
                of them, the ranks' peaks together within 76 GB): (a)
                ``ContinuousEngine`` with 4 slots, max_len 1,024, over the
                serve trace's first 4 requests (426, 75, 239, 110 tokens), 16
                new tokens, greedy: tokens equal on every rank, the logits
                of one prefill and one tick (both sides ticking on the
                prompt's last token: a bf16 argmax may part on a near-tie)
                within phase 7's bf16 tolerances of one process's; a tick
                counted whole and the
                MoE layer's part (``CommDebugMode``, staged calls, ms); (b)
                the same under ``CodedServeGuard(K=2, R=2, mesh=<the four
                ranks as "hosts">)``, host 3 killed after tick 8: tokens
                equal (a)'s on every rank, each rank's ``gf_matmul``
                launches one snapshot's calls a snapshot; (c) the float32
                smoke configs of DeepSeek-V3 and Arctic on the mesh on the
                card: the engine's tokens equal the CPU's, one train step
                within phase 8's tolerances of the CPU's; (d)
                ``launch/serve.py --mesh 2x2 --arch deepseek-v3-671b --layers
                4 --profile opt`` on two of (a)'s prompts, 4 new tokens, its
                own sharded draw: (a)'s first tokens. Each rank's held and
                peak bytes and draw seconds, prefill and tick ms, tokens/s,
                snapshot and recovery ms; the phase holds itself within 240 s.
18. ``families_mesh`` the SSM, encoder-decoder and VLM families on the
                mesh: the parent runs each model in one process on the card,
                in bf16 and in float32 (the bf16 weights upcast), and frees
                it; then one spawned world of four ranks runs, model by
                model at full width under the decode preset's ``opt`` rules,
                RWKV6-3B (4 of 32 layers), Jamba (8 of 32), Whisper-base
                (whole) and InternVL2-26B (6 of 48), each rank drawing its
                own blocks: (a) ``Engine`` over the serve trace's first 4
                prompts cut to 10, 6, 8 and 5 tokens, 8 new tokens, greedy:
                tokens equal on every rank; a prefill's and the fourth
                refeed tick's logits (both sides fed the same tokens) within
                phase 7's bf16 tolerances of one process's, except where one
                process's bf16 routing parts from float32's (a router
                near-tie), and always within the larger of those tolerances
                and 1.25x one process's distance from float32; a tick
                counted (``CommDebugMode``, staged calls and bytes, ms); (b)
                RWKV6 and Jamba: ``CodedServeGuard(K=2, R=2, mesh=<the four
                ranks as "hosts">)`` on the recurrent state at tick 4, host
                3 killed: the recovery bit-exact, the refeed resumed from it
                to (a)'s tokens, each rank's ``gf_matmul`` launches one
                snapshot's calls; (c) the four float32 smoke configs on the
                mesh on the card: the engine's tokens equal the CPU's, one
                train step within phase 8's tolerances of the CPU's; and
                ``launch/train.py --mesh 2x2 --smoke --coded-every 1`` of
                Whisper and InternVL2, rank 0's parity equal to a one-process
                guard's;
                (d) ``launch/serve.py --mesh 2x2 --arch whisper-base
                --profile opt`` on (a)'s prompts, 4 new tokens: (a)'s first
                tokens. Held, draw-peak and peak bytes (held equal to the
                specs' reckoning, the ranks' peaks within 70 GB together),
                draw seconds, tick ms, tokens/s, snapshot and recovery ms;
                the phase holds itself within 240 s.
19. a line ``{"kernels": [...]}`` with every kernel's launches on the main
   path, the coded path, the serve path, the train path, the ranks, the
   MoE, MLA, SSM, encoder-decoder and VLM serve paths, the analysis phase
   and the coded guards and every family on the mesh, error, time, bound
   and plain time;
   the card's name and power limit; and last ``{"ok": true, "device": {...}}``.

The widths, repeat counts and seed are the constants below: the script takes
no arguments. Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import gc
import hashlib
import importlib.util
import io
import json
import math
import os
import queue
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ProcessPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch import tree  # noqa: E402
from repro_torch.coded import gradient_coding  # noqa: E402
from repro_torch.configs import SHAPES as ARCH_SHAPES  # noqa: E402
from repro_torch.configs import get, shape_applicable, smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.coded.lagrange_compute import (  # noqa: E402
    build_lcc,
    lcc_decode,
    lcc_encode,
    lcc_encode_collective,
    lcc_encode_ranks,
    lcc_generator,
)
from repro_torch.coded import rs_checkpoint  # noqa: E402
from repro_torch.coded.rs_checkpoint import (  # noqa: E402
    build_parity_plan,
    column_blocks,
    encode_parity,
    encode_parity_collective,
    encode_parity_ranks,
    gather_state,
    shard_state_limbs,
)
from repro_torch.core.draw_loose import decode_dft, decode_draw_loose  # noqa: E402
from repro_torch.core.encode import a2a_encode, plan_for  # noqa: E402
from repro_torch.core.field import M31, NTT, Field, shoup_precompute, to_numpy, to_tensor  # noqa: E402
from repro_torch.core.ir import LocalOp, ir_permute_count  # noqa: E402
from repro_torch.core.matrices import butterfly_target_matrix, distinct_points, random_matrix, vandermonde  # noqa: E402
from repro_torch.core.prepare_shoot import encode_oracle  # noqa: E402
from repro_torch.core.schedule import draw_loose_target_matrix, plan_butterfly, plan_prepare_shoot  # noqa: E402
from repro_torch.dist.collectives import (  # noqa: E402
    allgather_encode,
    butterfly,
    expected_hier_permute_count,
    expected_multilevel_permute_count,
    expected_permute_count,
    hierarchical_encode,
    ir_encode,
    multilevel_encode,
    ps_encode,
)
from repro_torch.dist.ranks import (  # noqa: E402
    allgather_encode_ranks,
    butterfly_ranks,
    hierarchical_encode_ranks,
    ir_encode_ranks,
    multilevel_encode_ranks,
    ps_encode_ranks,
)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.butterfly.kernel import (  # noqa: E402
    MAX_SOURCES,
    butterfly_mac_plain,
    butterfly_mac_rows_cuda,
    butterfly_mac_rows_launcher,
    butterfly_mac_rows_plain,
)
from repro_torch.kernels.butterfly.ops import butterfly_mac, butterfly_mac_rows  # noqa: E402
from repro_torch.kernels.gf_matmul.kernel import (  # noqa: E402
    GENERAL,
    ROW_TILES,
    gf_matmul_cuda,
    gf_matmul_launcher,
    gf_matmul_plain,
    launch_plan,
    row_form,
)
from repro_torch.kernels.gf_matmul.ops import gf_matmul, gf_matmul_batched  # noqa: E402
from repro_torch.models import build_model, make_batch, train_batch_specs  # noqa: E402
from repro_torch.models import layers as model_layers  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.obs import MetricsRegistry, Tracer, drift_rows, feed_calibration, get_registry  # noqa: E402
from repro_torch.serve import coded as serve_coded  # noqa: E402
from repro_torch.serve.coded import CodedServeGuard, FaultInjector  # noqa: E402
from repro_torch.serve.engine import ContinuousEngine, Engine  # noqa: E402
from repro_torch.serve.scheduler import Request, bucket_for  # noqa: E402
from repro_torch.serve.traffic import LengthBand, poisson_trace  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.dist import pipeline_apply, stack_stage_params, staging  # noqa: E402
from repro_torch.launch.mesh import RankMesh, make_mesh  # noqa: E402
from repro_torch.launch.op_cost import count_fn  # noqa: E402
from repro_torch.launch.profiles import BASELINE, OPT, profile_with, rules_for  # noqa: E402
from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS, model_flops, render_table  # noqa: E402
from repro_torch.launch.roofline import load_all as roofline_load_all  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.train import (  # noqa: E402
    OptConfig,
    SyntheticLM,
    apply_updates,
    init_state,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
    state_specs,
)
from repro_torch.train import elastic  # noqa: E402
from repro_torch.train.data import to_device  # noqa: E402
from repro_torch.train.elastic import CodedStateGuard  # noqa: E402
from repro_torch.train.train_loop import (  # noqa: E402
    batch_shardings,
    cache_shardings,
    make_decode_step,
    make_prefill_step,
    opt_state_shardings,
    param_shardings,
    place,
)
from torch.distributed.tensor import DTensor  # noqa: E402
from repro_torch.topo import (  # noqa: E402
    FullyConnected,
    Hierarchy,
    plan_hierarchical,
    plan_multilevel,
    plan_two_level_dft,
    two_level_dft_matrix,
)
from repro_torch.topo.passes import PIPELINES  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA's data sheet): the yardsticks of
# ``bound_ms``. 32-bit integer multiply-adds run outside the tensor cores on
# half as many lanes as float32 (64 against 128 an SM), so their peak is taken
# as half the 67 TFLOP/s float32 rate.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2

PAYLOAD = 1 << 20  # elements a processor: 4 MiB packets
PLAIN_REPS = 3  # timed runs of each plain version (median)
TIMED_LAUNCHES = 30  # back-to-back launches of a kernel between one pair of events
COLD_BYTES = 100 * 10**6  # a kernel call that moves less is timed over rotating copies of its inputs (2x the L2)
ENCODE_REPS = 3  # timed runs of each encode (median), and encodes a profile
SAMPLE_COLS = 4096  # payload columns held against the host oracle
SEED = 0

KERNEL_SOURCES = {
    "gf_matmul": {
        "source": "src/repro_torch/csrc/gf_matmul.cu",
        "replaces": "src/repro/kernels/gf_matmul/kernel.py:125",
    },
    "butterfly_mac": {
        "source": "src/repro_torch/csrc/butterfly_mac.cu",
        "replaces": "src/repro/kernels/butterfly/kernel.py:55",
    },
}
# No single PyTorch call computes an exact mod-q matrix product of 31-bit
# residues (integer matmul is not offered on the card, a float one is not
# exact) or a Shoup multiply-accumulate: there is no library yardstick.
LIBRARY_MS = None


def say(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a, b))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of ``fn`` in ms over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_ms(launchers: list, n: int = TIMED_LAUNCHES) -> float:
    """Device ms one launch takes: ``n`` back-to-back launches between one
    pair of CUDA events, over ``n``. Each launcher enqueues one launch with
    its operand checks and output allocation done beforehand (``*_launcher``
    of the kernel modules), and the ``n`` launches are captured once in a
    CUDA graph and replayed, so that the host's pace (tens of µs a Python
    launch) cannot space them out: the events see the device. The launches
    cycle over the launchers, which hold copies of the inputs where one call
    moves less than ``COLD_BYTES`` (the L2 then holds none of them, as the
    caller would find it). Warmed up by one launch of each and one replay."""
    for launch in launchers:
        launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            launchers[i % len(launchers)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / n


def host_us(call, n: int = TIMED_LAUNCHES) -> float:
    """Host µs one call of a kernel's wrapper takes to return (checks,
    output, enqueue; no synchronise): on the ranks, the cost of a LocalOp
    that the device does not see."""
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def copies_for(nbytes: int) -> int:
    """How many copies of a call's inputs rotate so that their bytes pass
    ``COLD_BYTES``: 1 where one call moves that much already."""
    return max(1, -(-COLD_BYTES // max(nbytes, 1)))


def wall_ms(fn, reps: int) -> float:
    """Median wall time of ``fn`` in ms, synchronised before and after."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def rand_residues(shape, q: int, dev, seed: int) -> torch.Tensor:
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return torch.randint(0, q, shape, dtype=torch.int32, device=dev, generator=g)


def ptxas_by_kernel(log: str) -> list[dict]:
    """Registers, spills and static shared memory of each kernel that nvcc
    compiled, from its ``-Xptxas -v`` log, under demangled names."""
    rows, name, spill = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append({"kernel": name, "registers": int(m.group(1)), "spill_stores": spill[0],
                         "spill_loads": spill[1], "static_smem": int(smem.group(1)) if smem else 0})
            name = None
    try:  # demangle, where the machine has c++filt
        out = subprocess.run(["c++filt"], input="\n".join(r["kernel"] for r in rows), capture_output=True,
                             text=True, timeout=60).stdout.splitlines()
        if len(out) == len(rows):
            for r, n in zip(rows, out):
                r["kernel"] = re.sub(r"^void |\(anonymous namespace\)::", "", n).split("(")[0]
    except (OSError, subprocess.SubprocessError):
        pass
    return rows


def nvidia_smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
    )
    check(r.returncode == 0 and r.stdout.strip(), f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# the three configurations of the main path, and the shapes they hand the kernels
# ---------------------------------------------------------------------------


def make_configs() -> list[dict]:
    """Plans, IRs and target matrices of the full-width encodes (host-side
    work only). The first three run through ``a2a_encode`` and
    ``ir_encode``; each topology-aligned one runs through its own entry point
    (``entry``), built on the card by ``make`` and run on the IR ``ir``."""
    configs = []
    for name, kind, K, q, seed in (
        ("universal", "general", 64, M31, SEED + 100),
        ("dft", "dft", 64, NTT, SEED + 200),
        ("draw_loose", "vandermonde", 48, NTT, SEED + 300),
    ):
        f = Field(q)
        cfg = {"name": name, "kind": kind, "K": K, "q": q, "seed": seed, "A": None,
               "entries": ("a2a_encode", "ir_encode")}
        if kind == "general":
            cfg["A"] = random_matrix(f, K, seed=seed + 1)
            plan = plan_for("general", K, 1, q)
            cfg.update(plan=plan, ir=plan.to_ir(cfg["A"], q=q), target=np.asarray(cfg["A"]),
                       budget=expected_permute_count(plan))
        elif kind == "dft":
            plan = plan_for("dft", K, 1, q)
            cfg.update(plan=plan, ir=plan.to_ir(), target=butterfly_target_matrix(f, K, 2),
                       budget=plan.H * plan.p)
        else:
            plan = plan_for("vandermonde", K, 1, q, seed=seed + 1)
            ir = plan.to_ir()
            cfg.update(plan=plan, ir=ir, target=draw_loose_target_matrix(plan), budget=ir_permute_count(ir))
        configs.append(cfg)

    K, f = 64, Field(M31)
    A_univ = np.asarray(configs[0]["A"])
    A_hier = np.asarray(random_matrix(f, K, seed=SEED + 401))
    A_multi = np.asarray(random_matrix(f, K, seed=SEED + 501))
    hp = plan_hierarchical(K, 1, 8)
    mp = plan_multilevel(K, 1, (4, 4, 4))  # levels innermost first: sizes (4, 4, 4) reversed
    pp = plan_for("general", K, 1, M31)
    # the rewrite the dispatch applies: priced on the flat fabric at 2^16 elements
    pipelined_ir = PIPELINES["pipeline"].apply(pp.to_ir(A_univ, q=M31), FullyConnected(K), 1 << 16)
    tp = plan_two_level_dft(K, 1, NTT, 8)
    tp_ir = tp.to_ir()
    for name, q, seed, plan, ir, target, budget, entry, make in (
        ("hierarchical", M31, SEED + 400, hp, hp.to_ir(A_hier, q=M31), A_hier,
         expected_hier_permute_count(hp), "hierarchical_encode",
         lambda: hierarchical_encode(A_hier, k_intra=8)[0]),
        ("multilevel", M31, SEED + 500, mp, mp.to_ir(A_multi, q=M31), A_multi,
         expected_multilevel_permute_count(mp), "multilevel_encode",
         lambda: multilevel_encode(A_multi, (4, 4, 4))[0]),
        ("pipelined", M31, SEED + 100, pp, pipelined_ir, A_univ,
         expected_permute_count(pp), "ps_encode",
         lambda: ps_encode(A_univ, pipeline="pipeline")[0]),
        ("two_level_dft", NTT, SEED + 600, tp, tp_ir, two_level_dft_matrix(tp),
         ir_permute_count(tp_ir), "ir_encode",
         lambda: ir_encode(tp_ir, q=NTT)),
    ):
        configs.append({"name": name, "kind": "topology", "K": K, "q": q, "seed": seed, "A": None,
                        "plan": plan, "ir": ir, "target": np.asarray(target), "budget": budget,
                        "entries": (entry,), "make": make})
    return configs


def a2a_kernel_calls(cfg: dict, P: int) -> list[tuple]:
    """The kernel calls ``a2a_encode`` makes for one configuration, in order:
    ``("gf_matmul", (batch, M, K, N))`` or ``("butterfly_mac", (radix, B, P,
    rows))``, ``rows`` being ``"gathered"`` (one source every part reads
    through a row table: a butterfly round) or ``"slots"`` (one source a part,
    row b of each: a LocalOp's input slots)."""
    plan, K = cfg["plan"], cfg["K"]
    if cfg["kind"] == "general":  # shoot_init: w[k] = coefT[k] @ buf[k]
        return [("gf_matmul", (K, plan.n, plan.m, P))]
    if cfg["kind"] == "dft":  # one launch a butterfly round
        return [("butterfly_mac", (plan.radix, K, P, "gathered"))] * plan.H
    return draw_loose_calls(plan, P)


def draw_loose_calls(plan, P: int) -> list[tuple]:
    """The kernel calls of ``encode_draw_loose`` (and of
    ``decode_draw_loose``, the same calls in reverse order) at P elements a
    processor."""
    calls = []
    if plan.draw_plan is not None:  # M processors, (Z, P) as their payload
        d = plan.draw_plan
        calls.append(("gf_matmul", (plan.M, d.n, d.m, plan.Z * P)))
    if plan.loose_plan is not None:  # M butterflies of Z points over the (M·Z, P) rows
        lp = plan.loose_plan
        calls += [("butterfly_mac", (lp.radix, plan.M * plan.Z, P, "gathered"))] * lp.H
    return calls


def ir_kernel_calls(ir, P: int, batch: int | None = None) -> list[tuple]:
    """The kernel calls ``ir_encode(kernels="cuda")`` makes for ``ir``: a
    LocalOp with one general row (not uniformly 0 or 1 across processors) is
    one butterfly_mac over its input slots (at most ``MAX_SOURCES`` of them),
    with several, or more slots, one gf_matmul_batched.
    ``batch`` is the processors a launch covers: all ``ir.K`` on one card
    (``None``), 1 on each rank of ``ir_encode_ranks``."""
    batch = ir.K if batch is None else batch
    calls = []
    for step in ir.steps:
        if not isinstance(step, LocalOp):
            continue
        c = np.asarray(step.coeffs)  # (K, n_out, n_in)
        general = sum(
            1
            for i in range(c.shape[1])
            if not (np.all(c[:, i] == 0, axis=0) | np.all(c[:, i] == 1, axis=0)).all()
        )
        if general == 1 and c.shape[2] <= MAX_SOURCES:
            calls.append(("butterfly_mac", (c.shape[2], batch, P, "slots")))
        elif general >= 1:
            calls.append(("gf_matmul", (batch, general, c.shape[2], P)))
    return calls


def count_calls(calls: list[tuple]) -> tuple[int, int]:
    """(gf_matmul, butterfly_mac) launches in a list of kernel calls."""
    return (sum(1 for k, _ in calls if k == "gf_matmul"),
            sum(1 for k, _ in calls if k == "butterfly_mac"))


def in_blocks(calls_of, S: int, rows: int) -> list[tuple]:
    """The kernel calls of an encode of S columns that holds ``rows`` rows,
    run in column blocks (``rs_checkpoint.column_blocks``): ``calls_of(w)``
    for each block's width w, in order."""
    return [c for lo, hi in column_blocks(S, rows) for c in calls_of(hi - lo)]


def path_shapes(configs: list[dict], P: int) -> dict[str, list]:
    """kernel name → [(shape, q, [who calls it so])], each shape once, in the
    order the main path meets them (the first is the shape the kernels' line
    reports)."""
    seen: dict[str, dict] = {"gf_matmul": {}, "butterfly_mac": {}}
    for cfg in configs:
        if "runs" in cfg:  # a coded configuration lists its entry points' calls
            runs = tuple(cfg["runs"].items())
        elif cfg["kind"] == "topology":
            runs = ((cfg["entries"][0], ir_kernel_calls(cfg["ir"], P)),)
        else:
            runs = (("a2a_encode", a2a_kernel_calls(cfg, P)), ("ir_encode", ir_kernel_calls(cfg["ir"], P)))
        for entry, calls in runs:
            for kernel, shape in calls:
                who = seen[kernel].setdefault((shape, cfg["q"]), [])
                if f"{cfg['name']}/{entry}" not in who:
                    who.append(f"{cfg['name']}/{entry}")
    return {k: [(shape, q, who) for (shape, q), who in v.items()] for k, v in seen.items()}


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain version
# ---------------------------------------------------------------------------


def bound(nbytes: int, ops: int) -> dict:
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def kernel_row(name: str, cases: int, worst: int, at_shapes: list[dict]) -> dict:
    """The kernel's line: its numbers at the first main-path shape, and every
    main-path shape's numbers under ``shapes``."""
    first = at_shapes[0]
    return {
        "name": name,
        "route": "cuda",
        **KERNEL_SOURCES[name],
        "shape": first["shape"],
        "cases": cases + len(at_shapes),
        "max_abs_err": max([worst] + [r["max_abs_err"] for r in at_shapes]),
        **{k: first[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": LIBRARY_MS,
        "shapes": at_shapes,
    }


def check_gf_matmul(dev, shapes: list) -> dict:
    worst = 0
    cases = 0
    # the reference tests' shape grid: one block, multi-block, ragged, degenerate
    grid = [(8, 8, 128), (128, 512, 128), (256, 1024, 256), (130, 70, 200), (1, 16, 1),
            (13, 21, 130), (40, 100, 257), (16, 24, 8), (3, 5, 1021)]
    for q in (M31, NTT, 65537, 97):
        for i, (M, K, N) in enumerate(grid):
            a = rand_residues((M, K), q, dev, seed=M + K)
            b = rand_residues((K, N), q, dev, seed=N + K + 1)
            got = gf_matmul(a, b, q=q)
            want = gf_matmul_plain(a[None], b[None], q)[0]
            worst = max(worst, max_abs_err(got, want))
            check(same(got, want), f"gf_matmul != plain at {(M, K, N)}, q={q}")
            if i < 3 or q in (M31, NTT):
                host = Field(q).matmul(to_numpy(a), to_numpy(b)).astype(np.uint32)
                check(np.array_equal(to_numpy(got), host), f"gf_matmul != host oracle at {(M, K, N)}, q={q}")
            cases += 1
    for q in (M31, NTT):  # operands of all q-1: the accumulator's worst case
        a = torch.full((64, 512), q - 1, dtype=torch.int32, device=dev)
        b = torch.full((512, 128), q - 1, dtype=torch.int32, device=dev)
        got = gf_matmul(a, b, q=q)
        want = gf_matmul_plain(a[None], b[None], q)[0]
        worst = max(worst, max_abs_err(got, want))
        check(same(got, want), f"gf_matmul != plain on all q-1, q={q}")
        host = Field(q).matmul(to_numpy(a), to_numpy(b)).astype(np.uint32)
        check(np.array_equal(to_numpy(got), host), f"gf_matmul != host oracle on all q-1, q={q}")
        cases += 1
    # batched, ragged
    a = rand_residues((6, 9, 17), M31, dev, seed=3)
    b = rand_residues((6, 17, 5), M31, dev, seed=4)
    got = gf_matmul_batched(a, b, q=M31)
    check(same(got, gf_matmul_plain(a, b, M31)), "gf_matmul_batched != plain")
    cases += 1
    n, w = check_gf_matmul_forms(dev)
    cases, worst = cases + n, max(worst, w)
    # zero-size operands: guarded in ops, no launch
    before = gf_matmul_cuda.launches
    for M, K, N in [(0, 8, 8), (8, 0, 8), (8, 8, 0), (0, 0, 0)]:
        z = gf_matmul(
            torch.zeros((M, K), dtype=torch.int32, device=dev),
            torch.zeros((K, N), dtype=torch.int32, device=dev),
            q=M31,
        )
        check(z.shape == (M, N) and not z.any(), f"zero-size guard at {(M, K, N)}")
    check(gf_matmul_cuda.launches == before, "zero-size operands must not launch")

    # every shape the main path hands the kernel: batch x (M x K) . (K x N)
    at_shapes = []
    for i, ((B, M, K, N), q, who) in enumerate(shapes):
        a = rand_residues((B, M, K), q, dev, seed=11 + 2 * i)
        b = rand_residues((B, K, N), q, dev, seed=12 + 2 * i)
        want = gf_matmul_plain(a, b, q)
        got = gf_matmul_batched(a, b, q=q)
        err = max_abs_err(got, want)
        check(same(got, want), f"gf_matmul_batched != plain at the main-path shape {(B, M, K, N)}, q={q}")
        m_tile = launch_plan(M, N, b.data_ptr(), got.data_ptr())
        form = row_form(N, b.data_ptr(), got.data_ptr())
        del got, want
        nbytes = 4 * (a.numel() + b.numel() + B * M * N)
        inputs = [(a, b)] + [(a.clone(), b.clone()) for _ in range(copies_for(nbytes) - 1)]
        launchers = [gf_matmul_launcher(x, y, q)[0] for x, y in inputs]
        record = {
            "shape": f"batch {B} x ({M}x{K}).({K}x{N})", "q": q, "from": who, "max_abs_err": err,
            "m_tile": m_tile, "form": form,
            "ms": kernel_ms(launchers), "input_copies": len(inputs),
            "host_us": host_us(lambda: gf_matmul_cuda(a, b, q)),
            "plain_ms": cuda_ms(lambda: gf_matmul_plain(a, b, q), PLAIN_REPS, warmup=1),
            **bound(nbytes, 2 * B * M * K * N),
        }
        record["share_of_bound"] = record["bound_ms"] / record["ms"]
        at_shapes.append(record)
        del a, b, inputs, launchers
    return kernel_row("gf_matmul", cases, worst, at_shapes)


def check_gf_matmul_forms(dev) -> tuple[int, int]:
    """Every row tile of the row kernel in its aligned and its ragged form,
    and both forms of the general kernel (M = 17), each reached by the
    shapes that send the launch there, bit for bit against the plain version
    and, on the small cases, the host oracle: every M from 1 to 17, K in
    1..9 and 33, N % 4 in {0, 1, 2, 3}, tiles over several batch entries and
    blocks, A, B and C as views at 4-, 8- and 12-byte offsets with batch > 1
    and a ragged N (the rows of one launch start at different 16-byte
    phases; nothing outside C is written), all-(q-1) operands for every row
    tile in both forms and both primes, and a batch above 65,535. Returns
    (cases, worst)."""
    cases, worst = 0, 0
    reached = set()

    def hold(a, b, q, what, host=False, out=None) -> str:
        nonlocal cases, worst
        want = gf_matmul_plain(a, b, q)
        launch, got = gf_matmul_launcher(a, b, q, out=out)
        B, M, K = a.shape
        N = b.shape[2]
        m_tile = launch_plan(M, N, b.data_ptr(), got.data_ptr())
        kernel = "general" if m_tile == GENERAL else f"row tile {m_tile}"
        form = f"{kernel}, {row_form(N, b.data_ptr(), got.data_ptr())}"
        reached.add(form)
        launch()
        worst = max(worst, max_abs_err(got, want))
        check(same(got, want), f"gf_matmul ({form}) != plain at {what}, q={q}")
        cases += 1
        if host:
            f = Field(q)
            an, bn, wn = to_numpy(a), to_numpy(b), to_numpy(want)
            for z in range(B):
                check(np.array_equal(wn[z], f.matmul(an[z], bn[z]).astype(np.uint32)),
                      f"gf_matmul plain != host oracle at {what}, entry {z}, q={q}")
        return form

    def at_offset(shape, words: int, q: int, seed: int) -> torch.Tensor:
        """Residues in a contiguous view that starts ``words`` words into its buffer."""
        return rand_residues((words + math.prod(shape),), q, dev, seed)[words:].view(shape)

    for M in range(1, 18):
        for K in (*range(1, 10), 33):
            for N in (4100, 1029, 1030, 1031):  # N % 4 = 0, 1, 2, 3; ragged tiles
                q = M31 if (M + K + N) % 2 else NTT
                a = rand_residues((3, M, K), q, dev, seed=1000 + 100 * M + K)
                b = rand_residues((3, K, N), q, dev, seed=2000 + 100 * M + K + N)
                hold(a, b, q, f"batch 3 x ({M}x{K}).({K}x{N})", host=(N == 4100 and K in (1, 4, 9, 33)) or N == 1029)
    for M, K in ((2, 2), (8, 8), (16, 4), (5, 3)):  # many tiles a block, batch entries changing inside a block
        for N in ((1 << 16) + 4, (1 << 16) + 3):
            a = rand_residues((5, M, K), M31, dev, seed=3000 + M)
            b = rand_residues((5, K, N), M31, dev, seed=3001 + M + N)
            hold(a, b, M31, f"batch 5 x ({M}x{K}).({K}x{N})")
    # an operand that is a view at a 4-byte offset: the row kernel takes it, in its ragged form
    for q in (M31, NTT):
        M, K, N = 4, 8, 4096
        b = at_offset((2, K, N), 1, q, seed=4001)
        a = at_offset((2, M, K), 1, q, seed=4000)
        check(b.is_contiguous() and b.data_ptr() % 16 == 4, "the offset view is not where it should be")
        form = hold(a, b, q, f"B at a 4-byte offset, batch 2 x ({M}x{K}).({K}x{N})", host=True)
        check(form == "row tile 4, ragged", f"an unaligned B went to {form}, not the row kernel's ragged form")
    # A, B and C at 4-, 8- and 12-byte offsets, batch > 1, a ragged N: the phase changes from row to row
    offsets = [(b_off, c_off) for b_off in range(4) for c_off in range(4) if b_off or c_off]
    for i, (M, K, N) in enumerate(((2, 4, 4097), (2, 2, 4098), (16, 8, 1027), (1, 3, 8191), (4, 4, 2049),
                                   (8, 5, 1030))):
        q = M31 if i % 2 else NTT
        for j, (b_off, c_off) in enumerate(offsets if i < 2 else offsets[i::3]):
            a = at_offset((3, M, K), b_off, q, seed=4100 + 20 * i + j)
            b = at_offset((3, K, N), b_off, q, seed=4200 + 20 * i + j)
            buf = torch.full((c_off + 3 * M * N + 4,), -1, dtype=torch.int32, device=dev)
            out = buf[c_off:c_off + 3 * M * N].view(3, M, N)
            what = f"B at {4 * b_off} and C at {4 * c_off} bytes, batch 3 x ({M}x{K}).({K}x{N})"
            form = hold(a, b, q, what, host=i == 0, out=out)
            check(form.endswith("ragged"), f"{what} went to {form}")
            check(bool((buf[:c_off] == -1).all()) and bool((buf[c_off + 3 * M * N:] == -1).all()),
                  f"gf_matmul ({form}) wrote outside C at {what}")
    # operands of all q-1, the accumulator's worst case, at every row tile in both forms
    for q in (M31, NTT):
        for M in ROW_TILES:
            for K in (4, 5, 33):
                for N in (4100, 4101):
                    a = torch.full((2, M, K), q - 1, dtype=torch.int32, device=dev)
                    b = torch.full((2, K, N), q - 1, dtype=torch.int32, device=dev)
                    hold(a, b, q, f"all q-1, batch 2 x ({M}x{K}).({K}x{N})", host=True)
    # a batch the old grid's z axis could not hold
    a = rand_residues((65537, 2, 2), M31, dev, seed=5000)
    b = rand_residues((65537, 2, 4), M31, dev, seed=5001)
    hold(a, b, M31, "batch 65537 x (2x2).(2x4)")
    a = rand_residues((65537, 3, 2), NTT, dev, seed=5002)
    b = rand_residues((65537, 2, 3), NTT, dev, seed=5003)
    hold(a, b, NTT, "batch 65537 x (3x2).(2x3)")
    want = {f"{k}, {form}" for k in [f"row tile {t}" for t in ROW_TILES] + ["general"]
            for form in ("aligned", "ragged")}
    check(reached == want, f"gf_matmul's checks reached {sorted(reached)}, not every form {sorted(want)}")
    return cases, worst


def attained_copy(dev) -> dict:
    """What the card's memory attains on a plain 1 GiB device-to-device copy:
    the yardstick for how near a byte bound a kernel can come."""
    n = (1 << 30) // 4
    src = torch.empty(n, dtype=torch.int32, device=dev).fill_(1)
    dst = torch.empty_like(src)
    ms = cuda_ms(lambda: dst.copy_(src), 5)
    del src, dst
    moved = 2 * (1 << 30)  # read once, written once
    return {"bytes": 1 << 30, "ms": ms, "attained_bytes_per_s": moved / (ms / 1e3),
            "share_of_peak": moved / (ms / 1e3) / HBM_BYTES_PER_S}


OFFSET_ROW_WORDS = (1 << 30) + 1  # 3 such rows put the last past 2^31 elements


def butterfly_table(radix: int, B: int) -> np.ndarray:
    """The row table of a butterfly's first round over B rows (B % radix ==
    0): idx[ρ, b] is b with its lowest radix digit replaced by ρ, as a DFT
    round and the loose step of draw-and-loose hand the kernel."""
    b = np.arange(B)
    return np.stack([b - b % radix + r for r in range(radix)]).astype(np.int32)


def row_paths(sources, idx_np, B: int, P: int, out_ptr: int, out_stride: int | None = None) -> set:
    """The paths through the kernel that a launch's rows take: each (source
    phase, output phase) pair of 16-byte alignment (in words) that some part
    reads at, and "head", "tail" and "body" where some row has one. Output
    rows lie ``out_stride`` words apart (P when ``None``: a dense output)."""
    out_phase = (out_ptr // 4 + np.arange(B, dtype=np.int64) * (P if out_stride is None else out_stride)) % 4
    radix = len(sources) if idx_np is None else idx_np.shape[0]
    codes = set()
    for r in range(radix):
        x = sources[r if len(sources) > 1 else 0]
        rows = np.arange(B, dtype=np.int64) if idx_np is None else idx_np[r].astype(np.int64)
        stride = x.stride(0) if x.shape[0] > 1 else P
        src_phase = (x.data_ptr() // 4 + rows * stride) % 4
        codes |= set(np.unique(src_phase * 4 + out_phase).tolist())
    paths = {(c // 4, c % 4) for c in codes}
    head = np.minimum((4 - out_phase) % 4, P)
    body = (P - head) // 4
    tail = P - head - 4 * body
    paths |= {name for name, n in (("head", head), ("body", body), ("tail", tail)) if n.max() > 0}
    return paths


def hold_rows(sources, tw_np: np.ndarray, q: int, idx_np, what: str, reached: set, host: bool = False) -> int:
    """The kernel against the plain version on the same operands, bit for
    bit, and on small cases the plain version against the host oracle over
    the rows gathered in numpy. Adds the launch's paths (``row_paths``) to
    ``reached``; returns the error."""
    dev = sources[0].device
    B, radix = tw_np.shape
    P = sources[0].shape[1]
    tw, tw_sh = to_tensor(tw_np, dev), to_tensor(shoup_precompute(tw_np, q), dev)
    idx = None if idx_np is None else torch.as_tensor(idx_np, device=dev)
    want = butterfly_mac_rows_plain(sources, tw, tw_sh, q, idx=idx)
    got = butterfly_mac_rows_cuda(sources, tw, tw_sh, q, idx=idx)
    equal = same(got, want)  # the error only where they differ: int64 copies of 13 GB do not fit
    worst = 0 if equal else max_abs_err(got, want)
    check(equal, f"butterfly_mac_rows != plain at {what}, q={q}")
    reached |= row_paths(sources, idx_np, B, P, got.data_ptr())
    del got
    if host:
        f = Field(q)
        oracle = np.zeros((B, P), dtype=np.uint64)
        for r in range(radix):
            x = to_numpy(sources[r if len(sources) > 1 else 0])
            part = x[:B] if idx_np is None else x[idx_np[r]]
            oracle = f.add(oracle, f.mul(part, tw_np[:, r : r + 1]))
        check(np.array_equal(to_numpy(want), oracle.astype(np.uint32)),
              f"butterfly_mac_rows plain != host oracle at {what}, q={q}")
    return worst


OUT_SENTINEL = -7  # never a residue: the words around a strided output, which no launch may write


def hold_rows_into(sources, tw_np: np.ndarray, q: int, idx_np, what: str, reached: set, off: int, extra: int) -> int:
    """As :func:`hold_rows`, with the output a block of columns of a wider
    buffer filled with ``OUT_SENTINEL``: its rows ``off + P + extra`` words
    apart, starting at word ``off``. The kernel's buffer must equal the plain
    version's, word for word (the view and every word around it), and the
    view the dense result."""
    dev = sources[0].device
    B, radix = tw_np.shape
    P = sources[0].shape[1]
    tw, tw_sh = to_tensor(tw_np, dev), to_tensor(shoup_precompute(tw_np, q), dev)
    idx = None if idx_np is None else torch.as_tensor(idx_np, device=dev)
    bufs = [torch.full((B, off + P + extra), OUT_SENTINEL, dtype=torch.int32, device=dev) for _ in range(2)]
    want = butterfly_mac_rows_plain(sources, tw, tw_sh, q, idx=idx, out=bufs[0][:, off : off + P])
    got = butterfly_mac_rows_cuda(sources, tw, tw_sh, q, idx=idx, out=bufs[1][:, off : off + P])
    dense = butterfly_mac_rows_plain(sources, tw, tw_sh, q, idx=idx)
    around = torch.cat([bufs[0][:, :off], bufs[0][:, off + P :]], dim=1)
    equal = same(bufs[1], bufs[0]) and same(want, dense) and bool((around == OUT_SENTINEL).all())
    check(equal, f"butterfly_mac_rows into a strided output != plain at {what}, q={q}")
    reached |= row_paths(sources, idx_np, B, P, got.data_ptr(), got.stride(0) if B > 1 else None)
    return 0 if equal else max_abs_err(got, dense)


def check_butterfly_rows(dev) -> tuple[int, int, set]:
    """The row form at every path it has: every (source, output) pair of
    16-byte phases (sources that are views at word offsets 0-3 with rows P +
    1 to P + 3 apart, outputs of every P % 4); gathered, repeated and
    identity rows; one source for every part and one a part; radix 1 to 8
    and the cap; rows of head or tail alone; a batch of 65,537; and offsets
    past 2^31 elements in a source and in the output. Returns (cases, worst,
    reached)."""
    cases, worst, reached = 0, 0, set()
    rng = np.random.default_rng(SEED + 60)

    def twiddles(B, radix, q):
        tw_np = rng.integers(0, q, size=(B, radix), dtype=np.uint32)
        tw_np[0, 0] = q - 1  # a dual near 2^32
        return tw_np

    for P in (4100, 4097, 4098, 4099):  # output rows at every phase
        for radix in (2, 3, 4):
            q = M31 if (P + radix) % 2 else NTT
            srcs, idx = [], []
            for r in range(radix):
                off, stride, rows = (r + P) % 4, P + 1 + r % 3, 9 + r
                flat = rand_residues((off + rows * stride,), q, dev, seed=7000 + 10 * P + r)
                srcs.append(flat[off:].view(rows, stride)[:, :P])
                idx.append(rng.integers(0, rows, size=9))
            worst = max(worst, hold_rows(srcs, twiddles(9, radix, q), q, np.stack(idx).astype(np.int32),
                                         f"views at word offsets, P={P}, radix {radix}", reached, host=True))
            cases += 1
    for radix in range(1, 9):
        for q, P in ((M31, 1029), (NTT, 1032)):
            srcs = [rand_residues((7 + r, P), q, dev, seed=7100 + 10 * radix + r) for r in range(radix)]
            worst = max(worst, hold_rows(srcs, twiddles(7, radix, q), q, None,
                                         f"identity rows, radix {radix}, P={P}", reached, host=True))
            shared = rand_residues((20, P + 1), q, dev, seed=7200 + radix)
            idx = rng.integers(0, 20, size=(radix, 16)).astype(np.int32)
            idx[:, ::3] = 5  # a row read many times
            worst = max(worst, hold_rows([shared], twiddles(16, radix, q), q, idx,
                                         f"one gathered source, radix {radix}, P={P + 1}", reached, host=True))
            cases += 2
    srcs = [rand_residues((3, 37), NTT, dev, seed=7300 + r) for r in range(MAX_SOURCES)]
    worst = max(worst, hold_rows(srcs, twiddles(3, MAX_SOURCES, NTT), NTT, None, "radix at the cap", reached,
                                 host=True))
    cases += 1
    for P in (4100, 4097):  # outputs written through a row stride: every output phase by offset and stride
        q = M31 if P % 2 else NTT
        shared = rand_residues((12, P), q, dev, seed=7050 + P)
        for off in range(4):
            for extra in (1, 2, 3):
                idx = rng.integers(0, 12, size=(2, 9)).astype(np.int32)
                worst = max(worst, hold_rows_into([shared], twiddles(9, 2, q), q, idx,
                                                  f"output rows {off + P + extra} apart from word {off}, P={P}",
                                                  reached, off, extra))
                cases += 1
    for P in (1, 2, 3, 5, 6, 7):  # rows of head and tail, with a body of at most one chunk
        x = rand_residues((6, P), M31, dev, seed=7400 + P)
        worst = max(worst, hold_rows([x], twiddles(5, 2, M31), M31, rng.integers(0, 6, size=(2, 5)).astype(np.int32),
                                     f"P={P}", reached, host=True))
        cases += 1
    for P in (8, 6):  # a batch the old grid's y axis could not hold
        x = rand_residues((65540, P), NTT, dev, seed=7500 + P)
        worst = max(worst, hold_rows([x], twiddles(65537, 2, NTT), NTT,
                                     rng.integers(0, 65540, size=(2, 65537)).astype(np.int32),
                                     f"batch 65537, P={P}", reached))
        cases += 1
    # offsets past 2^31 elements: rows 2^30 + 1 words apart, in a source and in the output
    X = rand_residues((3, OFFSET_ROW_WORDS), M31, dev, seed=7600)
    worst = max(worst, hold_rows([X[:, :4099]], twiddles(3, 2, M31), M31,
                                 np.array([[2, 0, 1], [1, 2, 2]], dtype=np.int32),
                                 "source rows 2^30 + 1 words apart", reached))
    worst = max(worst, hold_rows([X], twiddles(3, 1, M31), M31, None, "output of 3 x (2^30 + 1)", reached))
    # and an output whose rows lie 2^30 + 1 words apart: columns of X's rows
    small = rand_residues((3, 4099), M31, dev, seed=7601)
    tw_np = twiddles(3, 1, M31)
    tw, tw_sh = to_tensor(tw_np, dev), to_tensor(shoup_precompute(tw_np, M31), dev)
    X[:, 4099:4115] = OUT_SENTINEL
    butterfly_mac_rows_cuda([small], tw, tw_sh, M31, out=X[:, :4099])
    want = butterfly_mac_rows_plain([small], tw, tw_sh, M31)
    equal = same(X[:, :4099], want) and bool((X[:, 4099:4115] == OUT_SENTINEL).all())
    check(equal, "butterfly_mac_rows into output rows 2^30 + 1 words apart != plain")
    worst = max(worst, 0 if equal else max_abs_err(X[:, :4099], want))
    cases += 3
    del X, small, want
    torch.cuda.empty_cache()
    want = {(sp, op) for sp in range(4) for op in range(4)} | {"head", "body", "tail"}
    check(want <= reached, f"butterfly_mac_rows' checks missed the paths {sorted(want - reached, key=str)}")
    return cases, worst, reached


def check_butterfly_mac(dev, shapes: list) -> dict:
    worst = 0
    cases = 0
    grid = [(2, 8, 16), (2, 256, 512), (3, 9, 100), (4, 64, 1000), (1, 5, 64),
            (2, 1, 1), (2, 7, 100), (3, 8, 128), (2, 9, 513)]
    for q in (M31, NTT):
        for radix, B, Pn in grid:
            parts = rand_residues((radix, B, Pn), q, dev, seed=B + Pn)
            tw_np = np.random.default_rng(radix * 1000 + B + Pn).integers(
                0, q, size=(B, radix), dtype=np.uint32
            )
            tw_np[0, 0] = q - 1  # a dual near 2^32
            tw, tw_sh = to_tensor(tw_np, dev), to_tensor(shoup_precompute(tw_np, q), dev)
            got = butterfly_mac(parts, tw, tw_sh, q=q)
            want = butterfly_mac_plain(parts, tw, tw_sh, q)
            worst = max(worst, max_abs_err(got, want))
            check(same(got, want), f"butterfly_mac != plain at {(radix, B, Pn)}, q={q}")
            f = Field(q)
            host = np.zeros((B, Pn), dtype=np.uint64)
            pn = to_numpy(parts)
            for r in range(radix):
                host = f.add(host, f.mul(pn[r], tw_np[:, r : r + 1]))
            check(np.array_equal(to_numpy(got), host.astype(np.uint32)),
                  f"butterfly_mac != host oracle at {(radix, B, Pn)}, q={q}")
            cases += 1
        # all q-1, and payload dims
        parts = torch.full((2, 16, 3, 5, 7), q - 1, dtype=torch.int32, device=dev)
        tw_np = np.full((16, 2), q - 1, dtype=np.uint32)
        tw, tw_sh = to_tensor(tw_np, dev), to_tensor(shoup_precompute(tw_np, q), dev)
        got = butterfly_mac(parts, tw, tw_sh, q=q)
        check(got.shape == (16, 3, 5, 7), "butterfly_mac payload dims")
        want = butterfly_mac_plain(parts.reshape(2, 16, -1), tw, tw_sh, q).reshape(16, 3, 5, 7)
        check(same(got, want), f"butterfly_mac != plain on all q-1, q={q}")
        cases += 1
    before = butterfly_mac_rows_cuda.launches
    z = butterfly_mac(
        torch.zeros((2, 4, 0), dtype=torch.int32, device=dev),
        torch.zeros((4, 2), dtype=torch.int32, device=dev),
        torch.zeros((4, 2), dtype=torch.int32, device=dev),
        q=M31,
    )
    check(z.shape == (4, 0) and butterfly_mac_rows_cuda.launches == before, "zero-size guard of butterfly_mac")
    n, w, reached = check_butterfly_rows(dev)
    cases, worst = cases + n, max(worst, w)

    # every shape the main path hands the kernel, as the main path hands it:
    # one source read through a butterfly round's table, or one source a slot
    at_shapes = []
    for i, ((radix, B, Pn, rows), q, who) in enumerate(shapes):
        if rows == "gathered":
            srcs, idx_np = (rand_residues((B, Pn), q, dev, seed=21 + 2 * i),), butterfly_table(radix, B)
        else:
            srcs = tuple(rand_residues((B, Pn), q, dev, seed=21 + 2 * i + 1000 * r) for r in range(radix))
            idx_np = None
        tw_np = np.random.default_rng(22 + 2 * i).integers(0, q, size=(B, radix), dtype=np.uint32)
        tw, tw_sh = to_tensor(tw_np, dev), to_tensor(shoup_precompute(tw_np, q), dev)
        idx = None if idx_np is None else torch.as_tensor(idx_np, device=dev)
        want = butterfly_mac_rows_plain(srcs, tw, tw_sh, q, idx=idx)
        got = butterfly_mac_rows_cuda(srcs, tw, tw_sh, q, idx=idx)
        err = max_abs_err(got, want)
        check(same(got, want), f"butterfly_mac_rows != plain at the main-path shape {(radix, B, Pn, rows)}, q={q}")
        wide = None
        if any(w.startswith("lcc_square") for w in who):  # a column block's last round: into the output's columns
            wide = torch.full((B, 3 * Pn + 6), OUT_SENTINEL, dtype=torch.int32, device=dev)
            view = wide[:, Pn + 2 : 2 * Pn + 2]
            butterfly_mac_rows_cuda(srcs, tw, tw_sh, q, idx=idx, out=view)
            check(same(view, want) and int((wide != OUT_SENTINEL).sum()) <= B * Pn,
                  f"butterfly_mac_rows into the output's columns != plain at {(radix, B, Pn, rows)}, q={q}")
        del got, want
        # the bound reads each input once: the rows the table names (a DFT
        # round reads each of its B rows for radix outputs), the twiddles and
        # the table, and writes the output once
        rows_read = radix * B if idx_np is None else len(np.unique(idx_np))
        nbytes = 4 * (rows_read * Pn + B * Pn + 2 * B * radix + (0 if idx_np is None else radix * B))
        inputs = [srcs] + [tuple(x.clone() for x in srcs) for _ in range(copies_for(nbytes) - 1)]
        launchers = [butterfly_mac_rows_launcher(x, tw, tw_sh, q, idx=idx)[0] for x in inputs]
        record = {
            "shape": f"({radix}, {B}, {Pn}), {rows}", "q": q, "from": who, "max_abs_err": err,
            "ms": kernel_ms(launchers), "input_copies": len(inputs),
            "host_us": host_us(lambda: butterfly_mac_rows(srcs, tw, tw_sh, q=q, idx=idx)),
            "plain_ms": cuda_ms(lambda: butterfly_mac_rows_plain(srcs, tw, tw_sh, q, idx=idx), PLAIN_REPS, warmup=1),
            **bound(nbytes, 2 * radix * B * Pn),
        }
        record["share_of_bound"] = record["bound_ms"] / record["ms"]
        if wide is not None:
            record["into_columns_ms"] = kernel_ms(
                [butterfly_mac_rows_launcher(x, tw, tw_sh, q, idx=idx, out=view)[0] for x in inputs])
            record["into_columns_row_stride"] = int(view.stride(0))
            del wide, view
        at_shapes.append(record)
        del launchers
        del srcs, inputs
        torch.cuda.empty_cache()
    row = kernel_row("butterfly_mac", cases, worst, at_shapes)
    row["paths_reached"] = sorted(map(str, reached))
    return row


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def plain_matrix_encode(x: torch.Tensor, G: np.ndarray, q: int) -> torch.Tensor:
    """out[k'] = Σ_k x[k]·G[k, k'] mod q in plain int64 torch on x's device,
    over the whole payload (chunked inside ``gf_matmul_plain``)."""
    K = x.shape[0]
    gt = to_tensor(np.ascontiguousarray(np.asarray(G).T).astype(np.uint32), x.device)
    return gf_matmul_plain(gt[None], x.reshape(1, K, -1), q)[0].reshape(x.shape)


def drive_encode(cfg: dict, dev, P: int):
    """One configuration through both entry points, counted and checked.
    Returns (record, timers) where timers re-run the two encodes for timing."""
    name, kind, K, q, seed = cfg["name"], cfg["kind"], cfg["K"], cfg["q"], cfg["seed"]
    plan, ir, target, budget, A = cfg["plan"], cfg["ir"], cfg["target"], cfg["budget"], cfg["A"]
    x = rand_residues((K, P), q, dev, seed=seed)
    torch.cuda.reset_peak_memory_stats()
    run_a2a = lambda: a2a_encode(x, A, plan=plan, q=q)[0]  # noqa: E731
    fn = ir_encode(ir, q=q, kernels="cuda")

    g0, b0 = gf_matmul_cuda.launches, butterfly_mac_rows_cuda.launches
    out_a2a = run_a2a()
    torch.cuda.synchronize()
    g1, b1 = gf_matmul_cuda.launches, butterfly_mac_rows_cuda.launches
    out_ir = fn(x)
    torch.cuda.synchronize()
    g2, b2 = gf_matmul_cuda.launches, butterfly_mac_rows_cuda.launches
    peak = torch.cuda.max_memory_allocated()

    a2a_expect = count_calls(a2a_kernel_calls(cfg, P))
    check((g1 - g0, b1 - b0) == a2a_expect,
          f"{name}: a2a_encode launched (gf, bf)={(g1 - g0, b1 - b0)}, expected {a2a_expect}")
    ir_expect = count_calls(ir_kernel_calls(ir, P))
    check((g2 - g1, b2 - b1) == ir_expect,
          f"{name}: ir_encode launched (gf, bf)={(g2 - g1, b2 - b1)}, expected {ir_expect}")
    check(fn.permutes_run == fn.permute_count == ir_permute_count(ir),
          f"{name}: executor ran {fn.permutes_run} permutations, IR has {ir_permute_count(ir)}")
    check(fn.permutes_run <= budget, f"{name}: {fn.permutes_run} permutations over budget {budget}")
    if kind == "general":
        check(fn.permutes_run == budget, f"{name}: {fn.permutes_run} permutations, expected {budget}")

    check(same(out_a2a, out_ir), f"{name}: a2a_encode and ir_encode(kernels='cuda') differ")
    n_cols = check_output(name, out_a2a, x, target, q, seed)
    if kind == "dft":
        check(same(decode_dft(out_a2a, plan), x), f"{name}: decode_dft(encode_dft(x)) != x")
    elif kind == "vandermonde":
        check(same(decode_draw_loose(out_a2a, plan), x), f"{name}: decode_draw_loose(encode) != x")
    del out_a2a, out_ir
    record = {
        "K": K, "p": 1, "q": q, "payload_elems": P, "algorithm": ir.algorithm,
        "c1": plan.c1, "c2": plan.c2,
        "launches_a2a": {"gf_matmul": g1 - g0, "butterfly_mac": b1 - b0},
        "launches_ir": {"gf_matmul": g2 - g1, "butterfly_mac": b2 - b1},
        "permutes": fn.permutes_run, "permute_budget": budget,
        "peak_bytes": peak, "checked_columns": {"plain_on_card": P, "host_oracle": n_cols},
    }
    return record, (run_a2a, lambda: fn(x))


def check_output(name: str, out: torch.Tensor, x: torch.Tensor, target: np.ndarray, q: int, seed: int) -> int:
    """``out`` is canonical, equals a plain ``x @ target mod q`` on the card
    over the whole payload and the host oracle on sampled columns; returns
    the number of sampled columns."""
    K, P = x.shape
    check(out.shape == (K, P) and out.dtype == torch.int32, f"{name}: output shape/dtype")
    check(bool(((out >= 0) & (out < q)).all()), f"{name}: output not canonical")
    want = plain_matrix_encode(x, target, q)
    check(same(out, want), f"{name}: encode != plain x @ G mod q on the card")
    del want
    cols = np.sort(np.random.default_rng(seed + 2).choice(P, size=min(SAMPLE_COLS, P), replace=False))
    cols_t = torch.as_tensor(cols, device=x.device)
    host = encode_oracle(to_numpy(x.index_select(1, cols_t)), target, q).astype(np.uint32)
    check(np.array_equal(to_numpy(out.index_select(1, cols_t)), host),
          f"{name}: encode != host oracle on {len(cols)} sampled columns")
    return len(cols)


def drive_entry(cfg: dict, dev, P: int):
    """One topology-aligned configuration through its own entry point,
    counted and checked. Returns (record, executor, input)."""
    name, K, q, seed = cfg["name"], cfg["K"], cfg["q"], cfg["seed"]
    x = rand_residues((K, P), q, dev, seed=seed)
    torch.cuda.reset_peak_memory_stats()
    fn = cfg["make"]()
    check(fn.device.type == "cuda" and fn.kernels == "cuda", f"{name}: the entry point did not run on the card")
    calls = ir_kernel_calls(fn.ir, P)
    check(calls == ir_kernel_calls(cfg["ir"], P),
          f"{name}: the entry point runs other kernel shapes than phase 3 held")
    g0, b0 = gf_matmul_cuda.launches, butterfly_mac_rows_cuda.launches
    out = fn(x)
    torch.cuda.synchronize()
    g1, b1 = gf_matmul_cuda.launches, butterfly_mac_rows_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    expect = count_calls(calls)
    check((g1 - g0, b1 - b0) == expect,
          f"{name}: {cfg['entries'][0]} launched (gf, bf)={(g1 - g0, b1 - b0)}, expected {expect}")
    check(fn.permutes_run == fn.permute_count == ir_permute_count(fn.ir) == cfg["budget"],
          f"{name}: executor ran {fn.permutes_run} permutations, the budget is {cfg['budget']}")
    n_cols = check_output(name, out, x, cfg["target"], q, seed)
    del out
    overlap = sum(1 for s in fn.ir.steps if isinstance(s, LocalOp) and s.overlap)
    record = {
        "K": K, "p": 1, "q": q, "payload_elems": P, "entry": cfg["entries"][0], "algorithm": fn.ir.algorithm,
        "c1": cfg["plan"].c1, "c2": cfg["plan"].c2, "overlap_local_ops": overlap,
        "kernel_calls": [f"{k} {s}" for k, s in calls],
        "launches": {"gf_matmul": g1 - g0, "butterfly_mac": b1 - b0},
        "receive_coefficient_transfers": sum(
            1 for r in fn.ir.rounds() for tr in r.transfers if tr.coeffs is not None),
        "permutes": fn.permutes_run, "permute_budget": cfg["budget"],
        "peak_bytes": peak, "checked_columns": {"plain_on_card": P, "host_oracle": n_cols},
    }
    return record, fn, x


def in_order(ir):
    """The same IR with every LocalOp's overlap flag cleared: the executor
    then runs each contraction on the main stream, in order."""
    steps = tuple(dataclasses.replace(s, overlap=False) if isinstance(s, LocalOp) else s for s in ir.steps)
    return dataclasses.replace(ir, steps=steps)


def kernel_kind(key: str) -> str:
    """The kind of a device kernel, by the name the profiler gives it."""
    k = key.lower()
    if "gf_matmul" in k or "butterfly_mac" in k:
        return "hand_kernels"
    if "index" in k or "gather" in k:
        return "gathers"
    if "cat" in k or "copy" in k or "memcpy" in k or "memset" in k:
        return "copies"
    return "elementwise"


PROFILE_WINDOW = "chip_smoke.window"  # the profiler's own range around a profiled window


def profile_encode(name: str, fn, reps: int, top: int = 6, kind=kernel_kind) -> dict:
    """``reps`` encodes under ``torch.profiler``: wall and device-busy ms an
    encode, the idle share, device time by kind of kernel (``kind`` names a
    kernel's kind), and the busiest device kernels by name. The wall is the
    profiler's own range around the window (a ``record_function``, closed
    after the device is synchronised), so wall and device intervals are read
    from one clock. Busy time is the union of the device intervals, so
    kernels that ran at once on two streams count once; it can exceed neither
    the kernels' sum nor the wall time, and the run fails if it does (rows
    counted twice). ``butterfly_mac_fed_by`` counts, by kind, the device
    kernel that ran just before each ``butterfly_mac`` launch on its stream,
    with the int64 -> int32 narrowing (``is_narrowing``) a kind of its own: a
    gather or another copy there is one that feeds the kernel its parts;
    ``butterfly_mac_fed_by_names`` names the gathers and copies."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(PROFILE_WINDOW):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    window = [ev for ev in prof.events() if ev.name == PROFILE_WINDOW and ev.device_type == DeviceType.CPU]
    check(len(window) == 1, f"{name}: the profiler recorded {len(window)} windows, not one")
    wall = (window[0].time_range.end - window[0].time_range.start) / 1e3 / reps
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or ev.key == PROFILE_WINDOW:
            continue  # an operator's row repeats the time of the kernels it launched; the
            # window's own range on the device timeline is no kernel
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((ev.key, dev_us / 1e3 / reps, ev.count / reps))
    check(bool(rows), f"{name}: the profiler saw no device kernel")
    rows.sort(key=lambda r: -r[1])
    kernel_sum = sum(r[1] for r in rows)
    # busy time is the union of the device intervals: kernels on two streams
    # (an overlap LocalOp) may run at once, and then the sum exceeds it
    device_events = sorted((ev for ev in prof.events() if ev.device_type == DeviceType.CUDA
                            and ev.name != PROFILE_WINDOW and ev.time_range.end > ev.time_range.start),
                           key=lambda ev: ev.time_range.start)
    spans = [(ev.time_range.start, ev.time_range.end) for ev in device_events]
    fed_by: dict = {}
    fed_names: dict = {}
    last_on_stream: dict = {}
    for ev in device_events:
        stream = getattr(ev, "device_resource_id", None)
        if "butterfly_mac" in ev.name:
            before = last_on_stream.get(stream)
            feeder = "nothing" if before is None else "narrowing" if is_narrowing(before.name) else kind(before.name)
            fed_by[feeder] = fed_by.get(feeder, 0) + 1
            if feeder in ("gathers", "copies"):
                fed_names[before.name] = fed_names.get(before.name, 0) + 1
        last_on_stream[stream] = ev
    check(bool(spans), f"{name}: the profiler gave no device intervals")
    union_us, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            union_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    union_us += cur_e - cur_s
    busy = union_us / 1e3 / reps
    check(busy <= kernel_sum * 1.001, f"{name}: busy {busy:.3f} ms exceeds the kernels' sum {kernel_sum:.3f} ms")
    check(busy <= wall, f"{name}: device busy {busy:.3f} ms exceeds the wall time {wall:.3f} ms")
    by_kind: dict = {}
    for key, ms, _ in rows:
        by_kind[kind(key)] = by_kind.get(kind(key), 0.0) + ms
    return {
        "wall_ms": wall,
        "device_busy_ms": busy,
        "device_kernel_sum_ms": kernel_sum,
        "device_kernels_launched": sum(c for _, _, c in rows),
        "idle_share": 1.0 - busy / wall,
        "ms_by_kind": by_kind,
        "device_kernels": [{"name": n[:80], "ms": ms, "calls": c} for n, ms, c in rows[:top]],
        "butterfly_mac_fed_by": fed_by,
        "butterfly_mac_fed_by_names": fed_names,
    }


def is_narrowing(name: str) -> bool:
    """Whether a device kernel is the cast that ends a Shoup multiply,
    ``core.field._narrow``'s ``.to(torch.int32)`` of a contiguous int64
    tensor: PyTorch's copy kernel with a loader that casts (its dtypes
    differ) and an ``int`` functor (it writes int32). A layout copy
    (``movedim(...).contiguous()`` of int32 parts) keeps its dtype and has no
    casting loader."""
    return "direct_copy_kernel_cuda" in name and "LoadWithCast" in name and "lambda(int)" in name


def check_not_fed(what: str, profile: dict, scales: int):
    """The encode's ``butterfly_mac`` launches read their parts where they
    lie: on the device timeline no gather and no copy runs just before one
    (the row form's callers build no ``(radix, B, P)`` stack, and a blocked
    encode's last round writes its block's columns of the output, so no
    store follows it), but for the int64 -> int32 narrowing
    (``is_narrowing``) that ends each of the encode's ``scales`` local scales
    a run, just before a loose step: it is the scale's own output."""
    fed = profile["butterfly_mac_fed_by"]
    check(sum(fed.values()) > 0, f"{what}: the profile saw no butterfly_mac launch")
    check(not fed.get("gathers") and not fed.get("copies") and fed.get("narrowing", 0) <= scales * ENCODE_REPS,
          f"{what}: a gather or a copy feeds butterfly_mac ({fed}; {profile['butterfly_mac_fed_by_names']})")


def traced_phase(cfg: dict, dev, P: int) -> dict:
    """``cfg`` (the multilevel configuration) through the traced executor
    twice, on its own hierarchy: outputs bit-equal to the untraced encode, one
    root span and one span a CommRound each call, permutations and registry
    counters as budgeted, then the calibration feed into a temporary file."""
    name, K, q, seed = cfg["name"], cfg["K"], cfg["q"], cfg["seed"]
    x = rand_residues((K, P), q, dev, seed=seed)
    plain = cfg["make"]()
    want = plain(x)
    ir, budget = plain.ir, cfg["budget"]
    topo = Hierarchy(levels=cfg["plan"].levels)
    reg = get_registry()
    reg.reset()
    tracer = Tracer()
    fn = ir_encode(ir, q=q, tracer=tracer, topo=topo)
    calls = 2
    g0, b0 = gf_matmul_cuda.launches, butterfly_mac_rows_cuda.launches
    for i in range(calls):
        out = fn(x)
        check(same(out, want), f"traced: call {i} != the untraced encode")
        check(fn.permutes_run == budget, f"traced: {fn.permutes_run} permutations, the budget is {budget}")
    g1, b1 = gf_matmul_cuda.launches, butterfly_mac_rows_cuda.launches
    expect = count_calls(ir_kernel_calls(ir, P))
    check((g1 - g0, b1 - b0) == (calls * expect[0], calls * expect[1]),
          f"traced: launched (gf, bf)={(g1 - g0, b1 - b0)}, expected {calls} x {expect}")
    del out
    roots = [s for s in tracer.spans if s.name == "ir_encode"]
    comm = [s for s in tracer.spans if "comm_round" in s.attrs]
    check(len(roots) == calls and all(s.parent is None for s in roots), "traced: one root span a call")
    check(len(comm) == calls * ir.c1 == calls * 6, f"traced: {len(comm)} round spans for {calls} x c1={ir.c1}")
    levels = [s.attrs["level"] for s in comm]
    check(levels == [0, 0, 1, 1, 2, 2] * calls, f"traced: round levels {levels}")
    check(all(s.dur_us > 0 for s in comm), "traced: a round span took no time")
    for i in range(calls):
        mine = comm[i * ir.c1:(i + 1) * ir.c1]
        check(all(tracer.spans[s.parent] is roots[i] for s in mine), "traced: round spans nest in their call")
        check(sum(s.attrs["ppermutes"] for s in mine) == budget, "traced: permutations of the spans != budget")
    snap = reg.snapshot()
    check(snap["encode.rounds"]["value"] == calls * ir.c1, f"traced: encode.rounds {snap['encode.rounds']}")
    check(snap["encode.ppermutes"]["value"] == calls * budget, f"traced: encode.ppermutes {snap['encode.ppermutes']}")
    wire = sum(s.attrs["wire_slots"] for s in comm) * P * 4
    check(snap["encode.bytes_on_wire"]["value"] == wire > 0, "traced: encode.bytes_on_wire")
    check(snap["encode.round_us{level=0}"]["count"] == levels.count(0), "traced: encode.round_us{level=0}")
    with tempfile.TemporaryDirectory() as d:
        fitted = feed_calibration(tracer.spans, os.path.join(d, "calibration.json"), n_levels=3)
    return {
        "K": K, "q": q, "payload_elems": P, "topology": f"Hierarchy(levels={topo.levels})",
        "calls": calls, "traced_call_ms": [s.dur_us / 1e3 for s in roots],
        "untraced_ms": wall_ms(lambda: plain(x), ENCODE_REPS),
        "rounds": [{"round": s.attrs["comm_round"], "level": s.attrs["level"], "msgs": s.attrs["msgs"],
                    "elems": s.attrs["elems"], "wire_slots": s.attrs["wire_slots"],
                    "measured_us": s.dur_us, "predicted_us": s.attrs["predicted_us"]} for s in comm],
        "counters": {k: v["value"] for k, v in snap.items() if v["type"] == "counter"},
        "calibration_label": "fitted from one card's gathers in HBM (K processors as a tensor axis), "
                             "not from links between cards",
        "fitted_level_costs": [{"level": j, "alpha_s": c.alpha, "beta_s_per_elem": c.beta}
                               for j, c in enumerate(fitted)],
        "drift_rows": drift_rows(tracer.spans),
    }


# ---------------------------------------------------------------------------
# phase 6: the coded layer at the widths of Qwen3-1.7B
# ---------------------------------------------------------------------------

# Qwen3-1.7B (src/repro/configs/qwen3_1_7b.py, hf:Qwen/Qwen3-1.7B)
D_MODEL, N_HEADS, N_KV_HEADS, HEAD_DIM, D_FF, N_LAYERS = 2048, 16, 8, 128, 6144, 28
SERVE_SLOTS, SERVE_POSITIONS = 4, 1024  # the KV cache the serving guard protects
CKPT_K, CKPT_LOST = 16, [1, 4, 6]  # K of benchmarks/bench_coded_ckpt.py
CKPT_STEP, CKPT_RAISE_AT = 3, 3  # the snapshot's step; the column block a second snapshot raises at
SERVE_K, SERVE_R, SERVE_KILLS = 6, 2, ((1, 3), (2, 0))  # tests/test_coded_serve.py:278, (tick, host) kills
SQUARE_K = 48  # 3 x 16: draw-and-loose with both a draw and a loose phase
# lcc_square's cache is cut to this many layers, for time: its host numpy lcc_decode from 48 took
# 76-97 s over all 28
SQUARE_LAYERS = 4
GC_K, GC_S, GC_DROP = 8, 2, (1, 5)  # gradient coding: workers, stragglers, the two dropped


def layer_param_shapes() -> dict[str, tuple]:
    """One decoder layer's parameters: attention, SwiGLU MLP, the two
    RMSNorms and the q/k norms."""
    q, kv = N_HEADS * HEAD_DIM, N_KV_HEADS * HEAD_DIM
    return {"wq": (D_MODEL, q), "wk": (D_MODEL, kv), "wv": (D_MODEL, kv), "wo": (q, D_MODEL),
            "gate": (D_MODEL, D_FF), "up": (D_MODEL, D_FF), "down": (D_FF, D_MODEL),
            "attn_norm": (D_MODEL,), "mlp_norm": (D_MODEL,), "q_norm": (HEAD_DIM,), "k_norm": (HEAD_DIM,)}


def meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def checkpoint_spec() -> dict:
    """The training state of the coded checkpoint, as meta tensors: bf16
    parameters, float32 Adam moments m and v, an int32 step and a bool mask
    with one flag a parameter (11 bytes: an odd count)."""
    shapes = layer_param_shapes()
    return {
        "params": {k: meta(s, torch.bfloat16) for k, s in shapes.items()},
        "opt": {"m": {k: meta(s, torch.float32) for k, s in shapes.items()},
                "v": {k: meta(s, torch.float32) for k, s in shapes.items()},
                "step": meta((), torch.int32)},
        "mask": meta((len(shapes),), torch.bool),
    }


def serve_spec(layers: int = N_LAYERS) -> tuple:
    """(cache, state) of the serving guard: the bf16 KV cache of ``layers``
    layers, a token buffer and per-slot positions."""
    slab = (SERVE_SLOTS, SERVE_POSITIONS, N_KV_HEADS, HEAD_DIM)
    cache = [{"k": meta(slab, torch.bfloat16), "v": meta(slab, torch.bfloat16)} for _ in range(layers)]
    state = {"tokens": meta((SERVE_SLOTS, SERVE_POSITIONS), torch.int32), "pos": meta((SERVE_SLOTS,), torch.int32)}
    return cache, state


def limb_count(spec) -> int:
    return sum(-(-t.numel() * t.element_size() // 2) for t in tree.leaves(spec))


def spec_bytes(spec) -> int:
    return sum(t.numel() * t.element_size() for t in tree.leaves(spec))


def make_state(spec, dev, seed: int):
    """Random leaves of ``spec``'s shapes and dtypes, made on ``dev`` from
    ``seed``."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def fill(m):
        if m.dtype == torch.bool:
            return torch.rand(m.shape, generator=g, device=dev) < 0.5
        if m.dtype == torch.int32:
            return torch.randint(0, 1 << 20, m.shape, generator=g, device=dev, dtype=torch.int32)
        return (torch.randn(m.shape, generator=g, device=dev) * 0.02).to(m.dtype)

    return tree.map(fill, spec)


def same_bits(a, b) -> bool:
    """Two pytrees of tensors hold the same structure, dtypes, shapes and bytes."""
    la, lb = tree.leaves(a), tree.leaves(b)
    if tree.structure(a) != tree.structure(b) or len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if x.dtype != y.dtype or x.shape != y.shape or x.device != y.device:
            return False
        if x.dtype != torch.bool:
            x, y = x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8)
        if not torch.equal(x, y):
            return False
    return True


def coded_configs() -> list[dict]:
    """The coded phase's configurations, host-side: state specs, shard widths,
    plans, and the kernel calls each entry point makes (``runs``)."""
    ck_spec, sv_spec = checkpoint_spec(), serve_spec()
    plan = build_parity_plan(CKPT_K)
    ps = plan.ps_plan
    S = -(-limb_count(ck_spec) // CKPT_K)
    lplan = build_lcc(SERVE_K, R=SERVE_R)
    lps = plan_prepare_shoot(lplan.N, lplan.p)
    S6 = -(-limb_count(sv_spec) // SERVE_K)
    qplan = build_lcc(SQUARE_K)
    sq_spec = serve_spec(SQUARE_LAYERS)
    S48 = -(-limb_count(sq_spec) // SQUARE_K)
    return [
        {"name": "coded_checkpoint", "q": M31, "K": CKPT_K, "S": S, "spec": ck_spec, "plan": plan,
         "seed": SEED + 700, "runs": {
             "CodedStateGuard.snapshot": in_blocks(lambda w: [("gf_matmul", (CKPT_K, ps.n, ps.m, w))], S, CKPT_K),
             "encode_parity_collective": in_blocks(lambda w: ir_kernel_calls(ps.to_ir(plan.A, q=M31), w), S, CKPT_K),
             "encode_parity_collective(4, 4)": in_blocks(lambda w: ir_kernel_calls(
                 plan_hierarchical(CKPT_K, plan.p, 4).to_ir(plan.A, q=M31), w), S, CKPT_K),
         }},
        {"name": "lcc_serve", "q": NTT, "K": SERVE_K, "S": S6, "spec": sv_spec, "plan": lplan,
         "seed": SEED + 800, "runs": {
             "CodedServeGuard.snapshot": in_blocks(lambda w: [("gf_matmul", (lplan.N, lps.n, lps.m, w))], S6, lplan.N),
             "CodedServeGuard.snapshot(collective=True)": in_blocks(
                 lambda w: ir_kernel_calls(lps.to_ir(lcc_generator(lplan), q=NTT), w), S6, lplan.N),
         }},
        {"name": "lcc_square", "q": NTT, "K": SQUARE_K, "S": S48, "spec": sq_spec, "plan": qplan,
         "seed": SEED + 800, "runs": {
             "lcc_encode": in_blocks(lambda w: draw_loose_calls(qplan.plan_omega, w)
                                     + draw_loose_calls(qplan.plan_alpha, w), S48, qplan.N),
         }},
    ]


def launches() -> tuple[int, int]:
    return gf_matmul_cuda.launches, butterfly_mac_rows_cuda.launches


def check_launches(name: str, entry: str, before: tuple, calls: list):
    got = tuple(a - b for a, b in zip(launches(), before))
    check(got == count_calls(calls), f"{name}: {entry} launched (gf, bf)={got}, expected {count_calls(calls)}")
    return {"gf_matmul": got[0], "butterfly_mac": got[1]}


@contextlib.contextmanager
def peak_of(sink: dict, entry: str):
    """The device memory one entry point needs: the bytes allocated as it
    starts (``held``) and the most allocated while it runs (``peak``), read
    as soon as it has returned, before any check runs."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    yield
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    sink[entry] = {"held_bytes": held, "peak_bytes": peak, "added_bytes": peak - held}


@contextlib.contextmanager
def timed(module, name: str, sink: list):
    """Record the wall ms of every call of ``module.name`` into ``sink``
    while the block runs: how the host numpy part of a recovery, or a
    snapshot's copies to the host, is timed inside the guard that calls it.
    Each call starts from a synchronised card, so that its time holds no
    wait for earlier device work."""
    fn = getattr(module, name)

    def wrapper(*args, **kw):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        sink.append((time.perf_counter() - t0) * 1e3)
        return out

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, fn)


def snapshot_that_raises(name: str, guard, cfg: dict, dev) -> dict:
    """A second snapshot, of another state, made to raise at its
    CKPT_RAISE_AT-th column block (``elastic.encode_parity`` wrapped here):
    the guard must keep its step and arrays (the host holds both,
    ``elastic.host_holds_both``), so that the recovery that follows is of the
    last snapshot. Its launches are a check's, not the main path's: the
    counts are put back."""
    other = make_state(cfg["spec"], dev, cfg["seed"] + 1)
    blocks = len(column_blocks(cfg["S"], cfg["K"]))
    need = 2 * guard._shards.nbytes
    keep, available = elastic.host_holds_both(need)
    check(keep, f"{name}: the host cannot hold two snapshots of {need:,} bytes (MemAvailable {available})")
    real, calls = elastic.encode_parity, [0]

    def encode_parity(x, plan):
        calls[0] += 1
        if calls[0] == CKPT_RAISE_AT:
            raise MemoryError(f"block {CKPT_RAISE_AT} of {blocks}, made to raise")
        return real(x, plan)

    counts = launches()
    shards, parity = guard._shards, guard._parity
    elastic.encode_parity = encode_parity
    t0 = time.perf_counter()
    try:
        guard.snapshot(other, step=CKPT_STEP + 1)
        raised = None
    except MemoryError as e:
        raised = str(e)
    finally:
        elastic.encode_parity = real
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    gf_matmul_cuda.launches, butterfly_mac_rows_cuda.launches = counts
    check(raised is not None and calls[0] == CKPT_RAISE_AT and blocks > CKPT_RAISE_AT,
          f"{name}: the second snapshot did not raise at block {CKPT_RAISE_AT} of {blocks} ({calls[0]} calls)")
    check(guard.step == CKPT_STEP and guard._shards is shards and guard._parity is parity,
          f"{name}: a snapshot that raised did not keep the last one (step {guard.step})")
    del other
    return {"raised_at_block": CKPT_RAISE_AT, "blocks": blocks, "kept_step": guard.step, "new_bytes": need,
            "mem_available": available, "seconds": seconds}


def drive_coded_checkpoint(cfg: dict, dev) -> tuple[dict, dict]:
    """``CodedStateGuard(K=16)``: snapshot, the parity through the three
    entry points, the plain and host-oracle checks, and the recovery of three
    lost replicas. Returns (record, timers)."""
    name, K, plan, runs = cfg["name"], cfg["K"], cfg["plan"], cfg["runs"]
    state = make_state(cfg["spec"], dev, cfg["seed"])
    peaks: dict = {}
    guard = CodedStateGuard(K=K, device=dev)
    before = launches()
    with peak_of(peaks, "CodedStateGuard.snapshot"):
        guard.snapshot(state, step=CKPT_STEP)
    counted = {"CodedStateGuard.snapshot": check_launches(name, "snapshot", before, runs["CodedStateGuard.snapshot"])}
    raised = snapshot_that_raises(name, guard, cfg, dev)
    shards, _ = shard_state_limbs(state, K, dev)
    check(shards.is_cuda and tuple(shards.shape) == (K, cfg["S"]), f"{name}: shards {tuple(shards.shape)}")
    check(np.array_equal(to_numpy(shards), guard._shards), f"{name}: the guard's shards differ from the limbs")
    parity = to_tensor(guard._parity, dev)
    outs = {}
    for entry, sizes in (("encode_parity_collective", None), ("encode_parity_collective(4, 4)", (4, 4))):
        before = launches()
        with peak_of(peaks, entry):
            fn = encode_parity_collective(plan, sizes, device=dev)
            outs[entry] = fn(shards)
        check(fn.device.type == "cuda" and fn.kernels == "cuda", f"{name}: {entry} did not run on the card")
        check(in_blocks(lambda w: ir_kernel_calls(fn.ir, w), cfg["S"], plan.K) == runs[entry],
              f"{name}: {entry} runs other kernel shapes than phase 3 held")
        counted[entry] = check_launches(name, entry, before, runs[entry])
        check(same(outs[entry], parity), f"{name}: {entry} != encode_parity")
    del outs
    n_cols = check_output(name, parity, shards, np.asarray(plan.A), M31, cfg["seed"])
    host_ms: list = []
    with peak_of(peaks, "CodedStateGuard.fail_and_recover"), timed(elastic, "recover_lost", host_ms):
        t0 = time.perf_counter()
        recovered, step = guard.fail_and_recover(CKPT_LOST)
        torch.cuda.synchronize()
        recover_ms = (time.perf_counter() - t0) * 1e3
    check(step == CKPT_STEP and same_bits(recovered, state),
          f"{name}: fail_and_recover({CKPT_LOST}) after a snapshot that raised is not the step-{CKPT_STEP} state, "
          f"bit for bit (step {step})")
    del recovered, parity
    record = {
        "K": K, "q": M31, "c1": plan.c1, "c2": plan.c2, "state_bytes": spec_bytes(cfg["spec"]),
        "limbs": int(guard._meta.total), "limbs_a_replica": cfg["S"], "leaves": len(tree.leaves(state)),
        "launches": counted, "memory": peaks,
        "checked_columns": {"plain_on_card": cfg["S"], "host_oracle": n_cols},
        "lost": CKPT_LOST, "recover_ms": recover_ms, "recover_lost_host_numpy_ms": host_ms[0],
        "overhead_elements": guard.overhead_elements, "snapshot_that_raises": raised,
    }
    flat = encode_parity_collective(plan, device=dev)
    timers = {"CodedStateGuard.snapshot": lambda: guard.snapshot(state, step=1),
              "encode_parity": lambda: encode_parity(shards, plan),
              "encode_parity_collective": lambda: flat(shards)}
    return record, timers


def drive_lcc_serve(cfg: dict, dev) -> tuple[dict, dict]:
    """``CodedServeGuard(K=6, R=2)`` with ``collective=False`` and ``True``:
    snapshot, two scheduled kills, recovery, counters and spans. Returns
    (record, timers)."""
    name, plan, runs = cfg["name"], cfg["plan"], cfg["runs"]
    cache, state = make_state(cfg["spec"], dev, cfg["seed"])
    peaks: dict = {}
    record = {"K": plan.K, "R": plan.R, "N": plan.N, "q": NTT, "state_bytes": spec_bytes(cfg["spec"]),
              "limbs_a_shard": cfg["S"], "leaves": len(tree.leaves((cache, state))), "kills": SERVE_KILLS}
    stored, guards, counted = {}, {}, {}
    for collective, entry in ((False, "CodedServeGuard.snapshot"),
                              (True, "CodedServeGuard.snapshot(collective=True)")):
        guard = CodedServeGuard(K=plan.K, R=plan.R, injector=FaultInjector(kills=SERVE_KILLS),
                                collective=collective, device=dev)
        if collective:
            enc = guard._collective
            check(enc.kernels == "cuda" and in_blocks(lambda w: ir_kernel_calls(enc.ir, w), cfg["S"], plan.N) == runs[entry],
                  f"{name}: {entry} runs other kernels than phase 3 held")
        reg, tracer = MetricsRegistry(), Tracer()
        guard.attach(reg, tracer)
        before = launches()
        with peak_of(peaks, entry):
            guard.snapshot(cache, state, tick=0)
        counted[entry] = check_launches(name, entry, before, runs[entry])
        stored[collective] = dict(guard.group._mem)
        dead = guard.poll(2) + guard.poll(3)
        check(dead == [h for _, h in SERVE_KILLS], f"{name}: poll found {dead} dead")
        host_ms: list = []
        with peak_of(peaks, f"CodedServeGuard.recover(collective={collective})"), \
                timed(serve_coded, "lcc_decode", host_ms):
            got_cache, got_state = guard.recover(dead)
        check(same_bits(got_cache, cache) and same_bits(got_state, state),
              f"{name}: recover({dead}) is not bit-exact (collective={collective})")
        stats = guard.stats()
        check(stats["recoveries"] == 2 and stats["injected_faults"] == 2 and stats["snapshots"] == 1,
              f"{name}: stats {stats}")
        snap = reg.snapshot()
        check(snap["serve.recoveries"]["value"] == 2 and snap["serve.snapshots"]["value"] == 1
              and snap["serve.recovery_us"]["count"] == 1, f"{name}: registry {snap}")
        check([s.name for s in tracer.spans] == ["serve.recovery"], f"{name}: spans {tracer.spans}")
        record[f"collective={collective}"] = {"stats": stats, "recover_ms": stats["recovery_us"]["p50"] / 1e3,
                                              "lcc_decode_host_numpy_ms": host_ms[0]}
        guards[collective] = guard
        del got_cache, got_state
    check(sorted(stored[False]) == sorted(stored[True]) == list(range(plan.N))
          and all(np.array_equal(stored[False][j], stored[True][j]) for j in range(plan.N)),
          f"{name}: collective=True gave other coded shards than collective=False")
    shards, _ = shard_state_limbs((cache, state), plan.K, dev)
    padded = torch.cat([shards, shards.new_zeros((plan.R, shards.shape[1]))])
    coded = to_tensor(np.stack([stored[False][j] for j in range(plan.N)]), dev)
    n_cols = check_output(name, coded, padded, lcc_generator(plan), NTT, cfg["seed"])
    record.update(launches=counted, memory=peaks,
                  checked_columns={"plain_on_card": cfg["S"], "host_oracle": n_cols})
    del coded, padded, shards
    timers = {f"CodedServeGuard.snapshot(collective={c})": (lambda g=g: g.snapshot(cache, state, tick=0))
              for c, g in guards.items()}
    return record, timers


def drive_lcc_square(cfg: dict, dev) -> tuple[dict, dict]:
    """``lcc_encode(build_lcc(48), X)`` over the serving state's limbs in 48
    shards: the plain check on the card and ``lcc_decode`` from all 48 coded
    shards back to X. Returns (record, timers)."""
    name, plan, runs = cfg["name"], cfg["plan"], cfg["runs"]
    X, _ = shard_state_limbs(make_state(cfg["spec"], dev, cfg["seed"]), plan.K, dev)
    peaks: dict = {}
    before = launches()
    with peak_of(peaks, "lcc_encode"):
        out = lcc_encode(plan, X)
    counted = {"lcc_encode": check_launches(name, "lcc_encode", before, runs["lcc_encode"])}
    n_cols = check_output(name, out, X, lcc_generator(plan), NTT, cfg["seed"])
    coded = to_numpy(out)
    t0 = time.perf_counter()
    back = lcc_decode(plan, coded, list(range(plan.N)))
    decode_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(back, to_numpy(X)), f"{name}: lcc_decode from {plan.N} responders != X")
    del out, coded, back
    record = {"K": plan.K, "M": plan.plan_omega.M, "Z": plan.plan_omega.Z, "q": NTT,
              "payload_elems": cfg["S"], "launches": counted, "memory": peaks,
              "checked_columns": {"plain_on_card": cfg["S"], "host_oracle": n_cols},
              "lcc_decode_host_numpy_ms": decode_ms}
    return record, {"lcc_encode": lambda: lcc_encode(plan, X)}


def drive_grad_coding(dev) -> dict:
    """``worker_combine`` of every worker and ``aggregate`` without two
    stragglers over one layer's float32 gradients, on the card and on the
    CPU: equal at rtol 1e-6, and the aggregate equal to the plain sum at the
    reference test's 1e-4."""
    plan = gradient_coding.build_grad_coding(GC_K, GC_S, seed=1)
    spec = {k: meta(s, torch.float32) for k, s in layer_param_shapes().items()}
    grads = {j: make_state(spec, dev, SEED + 900 + j) for j in range(GC_K)}
    out = {}
    for where, g in (("card", grads), ("cpu", {j: tree.map(lambda t: t.cpu(), gj) for j, gj in grads.items()})):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sent = {i: gradient_coding.worker_combine(plan, i, g) for i in range(GC_K)}
        total = gradient_coding.aggregate(plan, {i: c for i, c in sent.items() if i not in GC_DROP})
        torch.cuda.synchronize()
        out[where] = (total, (time.perf_counter() - t0) * 1e3)
    worst_rel, worst_abs = 0.0, 0.0
    for a, b in zip(tree.leaves(out["card"][0]), tree.leaves(out["cpu"][0])):
        check(a.is_cuda and a.dtype == torch.float32, "grad_coding: the card's aggregate is not float32 on the card")
        a = a.cpu()
        check(torch.allclose(a, b, rtol=1e-6, atol=0.0), "grad_coding: card and CPU differ beyond rtol 1e-6")
        diff = (a - b).abs()
        worst_abs = max(worst_abs, float(diff.max()))
        worst_rel = max(worst_rel, float((diff / b.abs().clamp_min(1e-30)).max()))
    plain = {k: sum(grads[j][k] for j in range(GC_K)) for k in spec}
    for k in spec:
        check(torch.allclose(out["card"][0][k], plain[k], rtol=1e-4, atol=1e-4),
              f"grad_coding: the aggregate of {k} != the plain sum at 1e-4")
    return {"K": GC_K, "s": GC_S, "dropped": list(GC_DROP), "values_a_gradient": spec_bytes(spec) // 4,
            "max_abs_err_card_vs_cpu": worst_abs, "max_rel_err_card_vs_cpu": worst_rel,
            "card_ms": out["card"][1], "cpu_ms": out["cpu"][1]}


def coded_phase(cfgs: list[dict], dev) -> tuple[dict, dict]:
    """The coded path (``cfgs`` from :func:`coded_configs`), counted on its
    own: every count is 0 before it and read after it. Then each
    configuration's times. Returns (launches, records)."""
    gf_matmul_cuda.launches = 0
    butterfly_mac_rows_cuda.launches = 0
    records, timers = {}, {}
    S_of = {cfg["name"]: cfg["S"] for cfg in cfgs}
    for cfg, drive in zip(cfgs, (drive_coded_checkpoint, drive_lcc_serve, drive_lcc_square)):
        records[cfg["name"]], timers[cfg["name"]] = drive(cfg, dev)
        torch.cuda.empty_cache()
    records["grad_coding"] = drive_grad_coding(dev)
    torch.cuda.empty_cache()
    counted = {"gf_matmul": gf_matmul_cuda.launches, "butterfly_mac": butterfly_mac_rows_cuda.launches}
    for k, n in counted.items():
        check(n > 0, f"the coded path never launched {k}")
    # times (these repeats are not part of the counted run)
    for name, entries in timers.items():
        record = records[name]
        for entry, run in entries.items():
            run()
            record[f"{entry}_ms"] = wall_ms(run, ENCODE_REPS)
        record["profile"] = {entry: profile_encode(f"{name}/{entry}", run, ENCODE_REPS)
                             for entry, run in entries.items()}
        if name == "lcc_square":  # the forward encode's scale, once a column block
            nb = len(column_blocks(S_of[name], SQUARE_K))
            check_not_fed(f"{name}/lcc_encode", record["profile"]["lcc_encode"], nb)
        timers[name] = None
        torch.cuda.empty_cache()
    return counted, records


# ---------------------------------------------------------------------------
# phase 7: the serving path at the full width of Qwen3-1.7B
# ---------------------------------------------------------------------------

SERVE_ARCH = "qwen3-1.7b"
# phase 7 serves Qwen3-1.7B at every width, cut from 28 to 14 layers
# to keep the script's time (1,212 s on one host before the cut): its three
# guarded runs' host decodes and its ticks go with the layer count
SERVE_LAYERS = 14
SERVE_BUCKETS = (128, 256, 512)  # prefill length buckets; SERVE_POSITIONS is max_len
SERVE_MAX_NEW = 32  # the engine's token budget; requests draw theirs from [16, 32]
SERVE_REQUESTS, SERVE_RATE = 12, 8.0  # a seeded Poisson trace, requests a second
SERVE_MIX = (LengthBand(16, 128, 0.4), LengthBand(129, 256, 0.3), LengthBand(257, 512, 0.3))
SERVE_SYNC = 4  # decode ticks a chunk: one host sync and one snapshot a chunk
SERVE_ENGINE_KILL = ((6, 3),)  # host 3 dies after tick 6: found at the second chunk's sync
SERVE_TEMPERATURE = 1.0
FIXED_PROMPTS = 4  # prompts of the trace through the fixed-batch Engine
REFEED_PLEN = 100  # prompt of the prefill-versus-refeed check (bucket 128)
# bf16 prefill against the per-token refeed: the logits' rms error within 5 %
# of their rms, the largest error within 10 % of the largest logit
REFEED_RMS_TOL, REFEED_MAX_TOL = 0.05, 0.10
# float32 smoke config on the card against the CPU (which the CPU tests hold
# against the reference): logits within this, greedy tokens equal
SMALL_LOGITS_ATOL = 1e-4


def serve_engine(model, params) -> ContinuousEngine:
    """The serve phase's continuous engine, on the device that holds ``params``."""
    return ContinuousEngine(model, params, n_slots=SERVE_SLOTS, max_len=SERVE_POSITIONS, buckets=SERVE_BUCKETS,
                            max_new_tokens=SERVE_MAX_NEW, metrics=MetricsRegistry())


def serve_state_spec(model) -> tuple:
    """(cache, state) that the guard snapshots, as meta tensors: the engine's
    own stacked KV cache and ``init_state()``, built on meta parameters."""
    eng = serve_engine(model, model.param_specs())
    return model.init_cache(SERVE_SLOTS, SERVE_POSITIONS, device="meta"), eng.init_state()


def serve_config() -> dict:
    """The serve phase's configuration, host-side: the model (Qwen3-1.7B
    cut to SERVE_LAYERS layers), the engine state's spec and shard width,
    the guard's plan and the kernel calls of one snapshot of each form
    (``runs``)."""
    cfg = get(SERVE_ARCH).replace(n_layers=SERVE_LAYERS)
    model = build_model(cfg)
    spec = serve_state_spec(model)
    plan = build_lcc(SERVE_K, R=SERVE_R)
    lps = plan_prepare_shoot(plan.N, plan.p)
    S = -(-limb_count(spec) // SERVE_K)
    return {"name": "serve", "q": NTT, "K": SERVE_K, "S": S, "spec": spec, "plan": plan, "model": model,
            "runs": {
                "ContinuousEngine.serve(guard)": in_blocks(lambda w: [("gf_matmul", (plan.N, lps.n, lps.m, w))], S, plan.N),
                "ContinuousEngine.serve(guard collective=True)": in_blocks(
                    lambda w: ir_kernel_calls(lps.to_ir(lcc_generator(plan), q=NTT), w), S, plan.N),
            }}


def tokens_of(report) -> dict:
    return {r.id: tuple(r.tokens) for r in report.results}


def check_report(what: str, rep, trace, vocab: int) -> dict:
    """Every request of the trace answered, within its budget, with token ids
    in the vocabulary; returns the report's numbers."""
    check([r.id for r in rep.results] == [r.id for r in sorted(trace, key=lambda r: (r.arrival_s, r.id))],
          f"serve/{what}: not every request was answered")
    by_id = {r.id: r for r in trace}
    for r in rep.results:
        req = by_id[r.id]
        check(r.prompt_len == len(req.prompt) and 1 <= r.gen_len <= req.max_new_tokens
              and r.tokens[: r.prompt_len] == list(req.prompt) and len(r.tokens) == r.prompt_len + r.gen_len,
              f"serve/{what}: {r.id} has {r.gen_len} tokens for a budget of {req.max_new_tokens}")
        check(all(0 <= t < vocab for t in r.tokens[r.prompt_len:]), f"serve/{what}: {r.id} left the vocabulary")
    return {"tokens_per_s": rep.tokens_per_s, "ttft_ms": rep.ttft_ms, "e2e_ms": rep.e2e_ms, "wall_s": rep.wall_s,
            "decode_steps": rep.decode_steps, "slot_occupancy": rep.slot_occupancy,
            "prefill_compiles": rep.prefill_compiles,
            "generated_tokens": sum(r.gen_len for r in rep.results)}


def tokens_sha256(tokens: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(tokens, dtype=np.int32).tobytes()).hexdigest()


def fixed_record(what: str, res, prompts, reg: MetricsRegistry, vocab: int) -> dict:
    """One greedy ``Engine.generate`` of ``prompts``: every row its prompt
    then SERVE_MAX_NEW tokens in the vocabulary; returns its numbers."""
    plens = np.array([len(p) for p in prompts])
    check(np.array_equal(res.lengths, plens + SERVE_MAX_NEW)
          and res.tokens.shape == (len(prompts), plens.max() + SERVE_MAX_NEW)
          and all(res.tokens[b, : plens[b]].tolist() == prompts[b] for b in range(len(prompts)))
          and bool(((res.tokens >= 0) & (res.tokens < vocab)).all()), f"{what}: lengths or tokens")
    snap = reg.snapshot()
    return {"steps": res.steps, "generate_ms": snap["serve.generate_ms"]["value"],
            "tokens_per_s": snap["serve.tokens_per_s"]["value"], "generated_tokens": int((res.lengths - plens).sum()),
            "sha256": tokens_sha256(res.tokens)}


def guarded_run(scfg: dict, eng, trace, dev, *, collective: bool, greedy: bool) -> tuple:
    """One serve of the trace under ``CodedServeGuard(K=6, R=2)`` with one
    scheduled kill: counted launches, each snapshot's wall ms, the recovery
    and the host numpy ms inside it. Returns (report, record)."""
    entry = "ContinuousEngine.serve(guard collective=True)" if collective else "ContinuousEngine.serve(guard)"
    guard = CodedServeGuard(K=SERVE_K, R=SERVE_R, injector=FaultInjector(kills=SERVE_ENGINE_KILL),
                            collective=collective, device=dev)
    if collective:
        enc = guard._collective
        check(enc.kernels == "cuda" and in_blocks(lambda w: ir_kernel_calls(enc.ir, w), scfg["S"], scfg["plan"].N)
              == scfg["runs"][entry],
              f"serve: {entry} runs other kernels than phase 3 held")
    snap_ms, host_ms = [], []
    before = launches()
    with timed(guard, "snapshot", snap_ms), timed(serve_coded, "lcc_decode", host_ms):
        rep = eng.serve(trace, greedy=greedy, sync_every=SERVE_SYNC, temperature=SERVE_TEMPERATURE, guard=guard)
    stats = rep.coded
    counted = check_launches("serve", entry, before, scfg["runs"][entry] * stats["snapshots"])
    check(stats["recoveries"] == 1 and stats["injected_faults"] == 1 and len(host_ms) == 1,
          f"serve: {entry} stats {stats}")
    check(all(len(v) == scfg["S"] for v in guard.group._mem.values()),
          f"serve: the coded shards are not {scfg['S']} limbs wide (the width phase 3 held)")
    return rep, {"snapshots": stats["snapshots"], "launches": counted,
                 "snapshot_ms": {"median": statistics.median(snap_ms), "max": max(snap_ms)},
                 "recover_ms": stats["recovery_us"]["p50"] / 1e3, "lcc_decode_host_numpy_ms": host_ms[0],
                 "requests_recovered": stats["requests_recovered"], "report": check_report(entry, rep, trace,
                                                                                            eng.model.cfg.vocab_size)}


def prefill_vs_refeed(model, params, dev) -> dict:
    """(f): ``prefill_into_cache`` of one REFEED_PLEN-token prompt against
    the same prompt refed token by token through ``decode_step``, bf16 on the
    card: the last position's logits within REFEED_RMS_TOL / REFEED_MAX_TOL
    of the logits' scale, and the K/V rows both write."""
    V = model.cfg.vocab_size
    prompt = np.random.default_rng(SEED + 1002).integers(1, V, size=REFEED_PLEN).astype(np.int32)
    bucket = bucket_for(REFEED_PLEN, SERVE_BUCKETS)
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :REFEED_PLEN] = prompt
    pf = make_prefill_step(model, into_cache=True)
    last, cache_pf = pf(params, model.init_cache(1, SERVE_POSITIONS, device=dev), torch.from_numpy(toks).to(dev),
                        0, REFEED_PLEN)
    step = make_decode_step(model)
    cache_rf = model.init_cache(1, SERVE_POSITIONS, device=dev)
    tok_t = torch.from_numpy(prompt).to(dev)
    for t in range(REFEED_PLEN):
        lg, cache_rf = step(params, cache_rf, tok_t[t: t + 1][None], torch.full((1,), t, dtype=torch.int32, device=dev))
    a, b = last[0, :V], lg[0, 0, :V]
    check(bool(torch.isfinite(a).all() and torch.isfinite(b).all()), "serve/refeed: logits not finite")
    err = (a - b).abs()
    rms, rms_err = float(b.pow(2).mean().sqrt()), float(err.pow(2).mean().sqrt())
    big, max_err = float(b.abs().max()), float(err.max())
    kv = max(float((x[:, 0, :REFEED_PLEN].float() - y[:, 0, :REFEED_PLEN].float()).abs().max())
             for x, y in zip(tree.leaves(cache_pf), tree.leaves(cache_rf)))
    rec = {"plen": REFEED_PLEN, "bucket": bucket, "logits_rms": rms, "rms_err": rms_err, "max_abs_err": max_err,
           "largest_logit": big, "tolerance": {"rms": REFEED_RMS_TOL, "max": REFEED_MAX_TOL},
           "argmax_equal": int(a.argmax()) == int(b.argmax()), "kv_rows_max_abs_err": kv}
    check(rms_err <= REFEED_RMS_TOL * rms and max_err <= REFEED_MAX_TOL * big,
          f"serve/refeed: prefill logits differ from the refeed's beyond the stated bf16 tolerance: {rec}")
    return rec


def small_reference(dev) -> dict:
    """The float32 smoke config of the same architecture on the card against
    the CPU, with the same parameters: forward logits within
    SMALL_LOGITS_ATOL and both engines' greedy tokens equal."""
    cfg = smoke_config(SERVE_ARCH).replace(dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator()
    gen.manual_seed(SEED + 1003)
    cpu_params = model.init(gen)
    card_params = tree.map(lambda t: t.to(dev), cpu_params)
    toks = torch.from_numpy(np.random.default_rng(SEED + 1004).integers(0, cfg.vocab_size, size=(2, 24)))
    lc = model.forward(cpu_params, {"tokens": toks})[0]
    lg = model.forward(card_params, {"tokens": toks.to(dev)})[0].cpu()
    err = float((lc - lg).abs()[..., : cfg.vocab_size].max())
    check(err <= SMALL_LOGITS_ATOL, f"serve/small: card and CPU logits differ by {err}")
    trace = poisson_trace(6, 1e4, max_new_tokens=6, vocab_size=cfg.vocab_size, seed=SEED + 1005)
    out = {}
    for where, p in (("cpu", cpu_params), ("card", card_params)):
        eng = ContinuousEngine(model, p, n_slots=2, max_len=160, buckets=(32, 64, 128), max_new_tokens=6,
                               metrics=MetricsRegistry())
        res = Engine(model, p, max_len=160, metrics=MetricsRegistry()).generate([r.prompt for r in trace],
                                                                                 max_new_tokens=6)
        out[where] = (tokens_of(eng.serve(trace, greedy=True, sync_every=2)), res.tokens.tolist(),
                      res.lengths.tolist())
    check(out["cpu"][0] == out["card"][0], "serve/small: continuous greedy tokens on the card differ from the CPU's")
    check(out["cpu"][1:] == out["card"][1:], "serve/small: fixed-batch greedy tokens on the card differ from the CPU's")
    return {"config": cfg.name, "dtype": "float32", "logits_max_abs_err": err, "requests": len(trace),
            "tokens_equal": True, "fixed_tokens_equal": True}


def serve_timings(model, params, eng, trace, dev, kind=kernel_kind, what: str = "serve") -> dict:
    """Prefill ms of each bucket, one decode tick's ms with every slot
    active, and one decode chunk under the profiler (not counted; ``kind``
    names a kernel's kind)."""
    state = eng.init_state()
    cache = model.init_cache(SERVE_SLOTS, SERVE_POSITIONS, device=dev)
    V = model.cfg.vocab_size
    out = {"prefill_ms": {}}
    for b in SERVE_BUCKETS:
        pf = eng._prefill_for(b, True)
        toks = torch.from_numpy(np.random.default_rng(b).integers(1, V, size=(1, b)).astype(np.int32)).to(dev)
        out["prefill_ms"][b] = wall_ms(lambda pf=pf, toks=toks: pf(params, cache, state, toks, 0, b, SERVE_MAX_NEW,
                                                                   -1, (0, 0), 1.0), 3)
    for s in range(SERVE_SLOTS):  # every slot holds a prompt and decodes
        req = trace[s]
        b = bucket_for(len(req.prompt), SERVE_BUCKETS)
        toks = np.zeros((1, b), np.int32)
        toks[0, : len(req.prompt)] = req.prompt
        eng._prefill_for(b, True)(params, cache, state, torch.from_numpy(toks).to(dev), s, len(req.prompt),
                                  SERVE_MAX_NEW, -1, (0, s), 1.0)
    state["max_gen"].fill_(1 << 30)  # stays active however often it is timed
    tick = eng._tick_for(True)
    out["decode_tick_ms"] = wall_ms(lambda: tick(params, cache, state, -1, 1.0), 10)

    def chunk():
        for _ in range(SERVE_SYNC):
            tick(params, cache, state, -1, 1.0)
        state["active"].cpu()

    chunk()
    out["decode_chunk_profile"] = profile_encode(f"{what}/decode_chunk", chunk, 1, kind=kind)
    return out


def serve_phase(scfg: dict, dev) -> tuple[dict, dict]:
    """The serving path at Qwen3-1.7B's full width (``scfg`` from
    :func:`serve_config`), counted on its own: (a) greedy, (b) greedy under
    the guard with one kill, equal to (a), (c) sampled under the guard with
    one kill, equal to the same sampled run unfailed, (d) the guard's
    ``collective=True`` form, equal to (a), (e) the fixed-batch Engine, (f)
    prefill against the per-token refeed, (g) the float32 smoke config on the
    card against the CPU. Returns (launches, record)."""
    model = scfg["model"]
    cfg = model.cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1000)
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    leaves = tree.leaves(params)
    check(all(t.is_cuda and t.dtype == torch.bfloat16 for t in leaves), "serve: the weights are not bf16 on the card")
    check(cfg.n_layers == SERVE_LAYERS and cfg.d_model == 2048 and cfg.vocab_padded == 152064
          and tuple(params["body"]["b0"]["mlp"]["w_up"].shape) == (SERVE_LAYERS, 2048, 6144),
          "serve: not Qwen3-1.7B's width")
    trace = poisson_trace(SERVE_REQUESTS, SERVE_RATE, mix=SERVE_MIX, max_new_tokens=SERVE_MAX_NEW,
                          vocab_size=cfg.vocab_size, seed=SEED + 1001)
    eng = serve_engine(model, params)
    record = {"arch": cfg.name, "params": sum(t.numel() for t in leaves),
              "param_bytes": sum(t.numel() * t.element_size() for t in leaves), "init_s": init_s,
              "init_peak_bytes": init_peak, "slots": SERVE_SLOTS, "max_len": SERVE_POSITIONS,
              "buckets": SERVE_BUCKETS, "max_new": SERVE_MAX_NEW,
              "sync_every": SERVE_SYNC, "trace": {"requests": len(trace), "rate_rps": SERVE_RATE, "seed": SEED + 1001,
                                                  "prompt_lens": [len(r.prompt) for r in trace],
                                                  "budgets": [r.max_new_tokens for r in trace]},
              "guard": {"K": SERVE_K, "R": SERVE_R, "q": NTT, "kills": SERVE_ENGINE_KILL,
                        "state_bytes": spec_bytes(scfg["spec"]), "limbs_a_shard": scfg["S"]}}

    gf_matmul_cuda.launches = 0
    butterfly_mac_rows_cuda.launches = 0
    rep_a = eng.serve(trace, greedy=True, sync_every=SERVE_SYNC)  # (a)
    greedy = tokens_of(rep_a)
    record["greedy"] = check_report("greedy", rep_a, trace, cfg.vocab_size)
    check(launches() == (0, 0), "serve: the unguarded run launched a hand kernel")
    rep_b, record["greedy_guarded"] = guarded_run(scfg, eng, trace, dev, collective=False, greedy=True)  # (b)
    check(tokens_of(rep_b) == greedy, "serve: greedy tokens after a kill and recovery differ from the unfailed run's")
    rep_c = eng.serve(trace, greedy=False, sync_every=SERVE_SYNC, temperature=SERVE_TEMPERATURE)  # (c)
    record["sampled"] = check_report("sampled", rep_c, trace, cfg.vocab_size)
    rep_c2, record["sampled_guarded"] = guarded_run(scfg, eng, trace, dev, collective=False, greedy=False)
    check(tokens_of(rep_c2) == tokens_of(rep_c), "serve: the sampled replay differs from its unfailed run")
    check(tokens_of(rep_c) != greedy, "serve: sampling at temperature 1.0 drew the greedy tokens")
    rep_d, record["greedy_guarded_collective"] = guarded_run(scfg, eng, trace, dev, collective=True,  # (d)
                                                             greedy=True)
    check(tokens_of(rep_d) == greedy, "serve: collective=True tokens after a kill differ from the unfailed run's")
    reg = MetricsRegistry()  # (e)
    fixed = Engine(model, params, max_len=SERVE_POSITIONS, metrics=reg)
    prompts = [r.prompt for r in trace[:FIXED_PROMPTS]]
    res = fixed.generate(prompts, max_new_tokens=SERVE_MAX_NEW)
    plens = np.array([len(p) for p in prompts])
    record["fixed"] = {"prompts": FIXED_PROMPTS, **fixed_record("serve/fixed", res, prompts, reg, cfg.vocab_size),
                       "first_tokens_equal_continuous": sum(
                           int(res.tokens[b, plens[b]]) == greedy[trace[b].id][plens[b]] for b in range(FIXED_PROMPTS))}
    # the refeed and the one-pass prefill pick the same first token (bf16; (f) bounds their logits' distance)
    check(record["fixed"]["first_tokens_equal_continuous"] == FIXED_PROMPTS,
          f"serve/fixed: first tokens equal the continuous engine's for "
          f"{record['fixed']['first_tokens_equal_continuous']} of {FIXED_PROMPTS} prompts")
    record["prefill_vs_refeed"] = prefill_vs_refeed(model, params, dev)  # (f)
    counted = {"gf_matmul": gf_matmul_cuda.launches, "butterfly_mac": butterfly_mac_rows_cuda.launches}
    check(counted["gf_matmul"] > 0, "the serve path never launched gf_matmul")
    record["launches"] = counted
    record["peak_bytes"] = torch.cuda.max_memory_allocated()
    record["small_reference"] = small_reference(dev)  # (g)
    record.update(serve_timings(model, params, eng, trace, dev))
    del params, eng, fixed
    torch.cuda.empty_cache()
    return counted, record


# ---------------------------------------------------------------------------
# phase 8: training of Qwen3-1.7B
# ---------------------------------------------------------------------------

TRAIN_ARCH = "qwen3-1.7b"
# (a): the launcher at its defaults (batch 8 x seq 256, lr 3e-4, K = 8) for six steps, with one coded snapshot of
# the whole state after the last one (step 5)
TRAIN_STEPS, TRAIN_CODED_EVERY, TRAIN_K = 6, 5, 8
TRAIN_ARGV = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--coded-every", str(TRAIN_CODED_EVERY)]
TRAIN_SNAPSHOT = "launch.train --coded-every 5: CodedStateGuard.snapshot"
SNAPSHOT_ADDED_MAX = 2 << 30  # the device bytes a snapshot may add beside the state it reads
TRAIN_PARITY_BLOCKS = 4  # (a): random column blocks whose parity is held, beside the first, the last and a leaf edge's
TRAIN_SHARD_EVERY = 16  # (a): every 16th column block of the guard's limbs is held (all 4,103 took 15 s), and the last
TRAIN_LOSS_SLACK = 1.5  # step 0's loss within this of ln(vocab): random weights guess uniformly
# (b): the float32 smoke config on the card against the CPU
SMALL_TRAIN_STEPS, SMALL_TRAIN_BATCH, SMALL_TRAIN_SEQ = 3, 8, 64
# The card and the CPU sum in other orders, so AdamW's first step (from zero
# moments, mhat / sqrt(vhat) = sign(g)) may move an element whose gradient
# lies within float error of 0 by 2 lr the other way: every parameter lies
# within 2 x (the run's summed lr) x SMALL_STEP_SLACK + SMALL_TIGHT of the
# CPU's, at most SMALL_FRACTION of a leaf's elements beyond SMALL_TIGHT; the
# moments within SMALL_MOMENT_SCALE of the leaf's largest value; each
# step's loss within SMALL_LOSS_ATOL. (Against the reference on the CPU the
# port measured at most 2e-5, 0 % beyond 1e-5, 4e-5 and 1.4e-6.)
SMALL_STEP_SLACK, SMALL_TIGHT, SMALL_FRACTION = 1.05, 1e-5, 0.01
SMALL_MOMENT_SCALE, SMALL_LOSS_ATOL = 1e-3, 1e-5
# (c): tests/test_system.py at its own cut, one layer of the smoke config
RESUME_OPT = OptConfig(lr=1e-3, warmup_steps=2, total_steps=50)
RESUME_K, RESUME_LOST, RESUME_BATCH, RESUME_SEQ = 8, [1, 4, 6], 2, 16


def train_kernel_kind(key: str) -> str:
    """The kind of a device kernel of a train step, by its profiler name."""
    k = key.lower()
    if any(w in k for w in ("gemm", "cutlass", "xmma", "nvjet", "sm90_", "cublas")):
        return "matmul"
    if "reduce" in k:
        return "reductions"
    return kernel_kind(key)


def resume_model():
    return build_model(smoke_config(TRAIN_ARCH).replace(n_layers=1))


def train_config() -> dict:
    """The train phase's configuration, host-side: the resume's state spec,
    its shard width and the kernel calls of one snapshot (``runs``), and
    those of (a)'s snapshot of the full-width state (the launcher's
    ``OptConfig`` for TRAIN_STEPS steps)."""
    model = resume_model()
    spec = {"params": model.param_specs(), "opt": state_specs(RESUME_OPT, model.param_specs())}
    plan = build_parity_plan(RESUME_K)
    S = -(-limb_count(spec) // RESUME_K)
    full = build_model(get(TRAIN_ARCH))
    ocfg = OptConfig(lr=3e-4, warmup_steps=max(TRAIN_STEPS // 10, 1), total_steps=TRAIN_STEPS)
    full_spec = {"params": full.param_specs(), "opt": state_specs(ocfg, full.param_specs())}
    fplan = build_parity_plan(TRAIN_K)
    S_full = -(-limb_count(full_spec) // TRAIN_K)
    return {"name": "train_resume", "q": M31, "K": RESUME_K, "S": S, "spec": spec, "plan": plan,
            "full": {"K": TRAIN_K, "S": S_full, "plan": fplan, "state_bytes": spec_bytes(full_spec)},
            "runs": {"CodedStateGuard.snapshot": in_blocks(
                         lambda w: [("gf_matmul", (RESUME_K, plan.ps_plan.n, plan.ps_plan.m, w))], S, RESUME_K),
                     TRAIN_SNAPSHOT: in_blocks(
                         lambda w: [("gf_matmul", (TRAIN_K, fplan.ps_plan.n, fplan.ps_plan.m, w))], S_full, TRAIN_K)}}


def mem_total() -> int:
    """The host's memory in bytes (``/proc/meminfo``'s ``MemTotal``)."""
    with open("/proc/meminfo") as fh:
        return int(fh.readline().split()[1]) * 1024


def leaf_u8(leaf: torch.Tensor) -> torch.Tensor:
    """A leaf's bytes, flat (a bool's as ``uint8``)."""
    t = leaf.detach()
    return (t.to(torch.uint8) if t.dtype == torch.bool else t).contiguous().view(-1).view(torch.uint8)


def leaf_limb_starts(leaves) -> list[int]:
    """Each leaf's first limb and, last, the limb count: a leaf takes its
    byte count over 2, rounded up."""
    starts = [0]
    for leaf in leaves:
        starts.append(starts[-1] + -(-leaf.numel() * leaf.element_size() // 2))
    return starts


def plain_limbs(leaves, a: int, b: int, dev) -> torch.Tensor:
    """Limbs ``[a, b)`` of a state whose leaves are ``leaves`` (pytree
    order), paired here from each leaf's bytes without the coded layer's
    readers: the leaves' bytes, each padded with a zero to an even count,
    laid end to end, zeros past the last, two little-endian bytes a limb."""
    u8 = torch.zeros(2 * (b - a), dtype=torch.uint8, device=dev)
    o = 0
    for leaf in leaves:
        if o >= 2 * b:
            break
        n = leaf.numel() * leaf.element_size()
        lo, hi = max(2 * a, o), min(2 * b, o + n)
        if lo < hi:
            u8[lo - 2 * a : hi - 2 * a] = leaf_u8(leaf)[lo - o : hi - o]
        o += n + n % 2
    pairs = u8.view(-1, 2).to(torch.int32)
    return pairs[:, 0] | (pairs[:, 1] << 8)


def plain_block(leaves, K: int, S: int, lo: int, hi: int, dev) -> torch.Tensor:
    """Columns ``[lo, hi)`` of the state's K limb rows of S
    (:func:`plain_limbs` for each row)."""
    return torch.stack([plain_limbs(leaves, j * S + lo, j * S + hi, dev) for j in range(K)])


def leaf_edge_block(starts: list[int], S: int, K: int) -> int:
    """The index of a column block, neither the first nor the last, that a
    leaf boundary (``starts``: :func:`leaf_limb_starts`) crosses (falls
    strictly inside)."""
    last = len(column_blocks(S, K)) - 1
    w = rs_checkpoint.block_columns(K)
    for b in starts[1:-1]:
        col = b % S
        if col % w and 0 < col // w < last:
            return col // w
    raise AssertionError("no leaf boundary falls inside a column block")


def check_snapshot(name: str, guard, state, fcfg: dict, dev, every: int) -> dict:
    """A blocked ``CodedStateGuard`` snapshot of ``state`` against the state:
    every ``every``-th block of ``guard._shards`` (and the last) equals the
    state's limbs paired again on the card from its leaves' bytes
    (:func:`plain_block`, not the guard's reader); the parity of the first
    block, the ragged last one, one a leaf boundary crosses and
    TRAIN_PARITY_BLOCKS random ones equals the plain ``x @ A mod q`` of those
    limbs on the card and, on ``check_output``'s random columns, the host
    oracle. Returns the record."""
    K, S, plan = fcfg["K"], fcfg["S"], fcfg["plan"]
    check(guard._shards.shape == guard._parity.shape == (K, S) and guard._shards.dtype == np.uint32,
          f"{name}: shards {guard._shards.shape}, parity {guard._parity.shape}, not ({K}, {S})")
    leaves = tree.leaves(state)
    starts = leaf_limb_starts(leaves)
    check(-(-starts[-1] // K) == S, f"{name}: {starts[-1]} limbs do not make {K} rows of {S}")
    blocks = column_blocks(S, K)
    t0 = time.perf_counter()
    shard_blocks = sorted(set(range(0, len(blocks), every)) | {len(blocks) - 1})
    for i in shard_blocks:
        lo, hi = blocks[i]
        held = torch.from_numpy(np.ascontiguousarray(guard._shards[:, lo:hi]).view(np.int32)).to(dev)
        check(same(plain_block(leaves, K, S, lo, hi, dev), held),
              f"{name}: the guard's limbs differ from the state's in block {i}")
    shards_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    edge = leaf_edge_block(starts, S, K)
    rng = np.random.default_rng(SEED + 1300)
    picked = sorted({0, len(blocks) - 1, edge} | set(rng.choice(len(blocks), TRAIN_PARITY_BLOCKS).tolist()))
    x = torch.cat([plain_block(leaves, K, S, *blocks[i], dev) for i in picked], dim=1)
    par = torch.cat([torch.from_numpy(np.ascontiguousarray(guard._parity[:, slice(*blocks[i])]).view(np.int32))
                     for i in picked], dim=1).to(dev)
    n_cols = check_output(f"{name}/parity", par, x, np.asarray(plan.A), plan.q, SEED + 1300)
    parity_s = time.perf_counter() - t0
    return {"blocks": len(blocks), "block_columns": rs_checkpoint.block_columns(K),
            "shard_blocks_checked": len(shard_blocks), "shard_check_s": shards_s, "parity_blocks_checked": picked,
            "leaf_edge_block": edge, "checked_columns": {"plain_on_card": int(x.shape[1]), "host_oracle": n_cols},
            "parity_check_s": parity_s}


def train_full_width(tcfg: dict, dev) -> dict:
    """(a): six steps of the launcher at Qwen3-1.7B's full width and depth
    with one coded snapshot of the whole state after the last, read by
    :func:`guard_calls` (its wall and device bytes; the steps' peak before
    it) and :func:`timed` (its copies to the host), and held by
    :func:`check_snapshot`; then one more step and one ``apply_updates``
    under the profiler."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # what earlier phases still hold
    calls, copy_ms = {}, []
    before = launches()
    t0 = time.perf_counter()
    with guard_calls(CodedStateGuard, calls, memory=True), timed(rs_checkpoint.HostRows, "put", copy_ms):
        run = train_main(TRAIN_ARGV)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = max(torch.cuda.max_memory_allocated(), calls.get("before_peak_bytes", 0))
    counted = check_launches("train", TRAIN_SNAPSHOT, before, tcfg["runs"][TRAIN_SNAPSHOT])
    model, ocfg, state, hist = run["model"], run["opt_cfg"], run["state"], run["history"]
    guard = run["guard"]
    check(len(calls.get("snapshot_ms", [])) == 1 and guard.step == TRAIN_CODED_EVERY,
          f"train: {len(calls.get('snapshot_ms', []))} snapshots, the last at step {guard.step}, "
          f"expected one at step {TRAIN_CODED_EVERY}")
    snap = {"step": guard.step, "wall_ms": calls["snapshot_ms"][0], **calls.get("memory", [{}])[0],
            "steps_peak_bytes": calls.get("before_peak_bytes"), "copy_to_host_ms": sum(copy_ms),
            "copies": len(copy_ms), "launches": counted}
    check(snap.get("added_bytes", 0) <= SNAPSHOT_ADDED_MAX,
          f"train: the snapshot added {snap.get('added_bytes')} device bytes, over {SNAPSHOT_ADDED_MAX}")
    snap.update(check_snapshot("train/snapshot", guard, state, tcfg["full"], dev, every=TRAIN_SHARD_EVERY),
                host_bytes=guard._shards.nbytes + guard._parity.nbytes, mem_total=mem_total())
    # what a second snapshot would decide: keep this one while it makes its
    # arrays, or drop it first (no second full-width snapshot is run)
    keep, available = elastic.host_holds_both(snap["host_bytes"])
    snap["next_snapshot"] = {"new_bytes": snap["host_bytes"], "mem_available": available,
                             "margin": elastic.HOST_MARGIN, "keeps_the_last": keep}
    print(f"train: a second full-width snapshot needs {snap['host_bytes']:,} new host bytes beside "
          f"MemAvailable {available if available is None else f'{available:,}'} (margin {elastic.HOST_MARGIN:,}): "
          f"{'keeps' if keep else 'drops'} the last one first", flush=True)
    del guard
    run["guard"] = None
    cfg = model.cfg
    params, opt = state["params"], state["opt"]
    check(cfg.n_layers == 28 and cfg.d_model == 2048 and cfg.vocab_padded == 152064 and cfg.remat == "block"
          and tuple(params["body"]["b0"]["mlp"]["w_up"].shape) == (28, 2048, 6144), "train: not Qwen3-1.7B's width")
    check(all(t.is_cuda for t in tree.leaves(state)) and params["embed"].dtype == torch.bfloat16
          and opt["m"]["embed"].dtype == torch.float32, "train: the state is not bf16 weights, float32 moments on the card")
    losses = [h["loss"] for h in hist]
    check(len(hist) == 6 and all(np.isfinite(losses)), f"train: losses {losses}")
    uniform = float(np.log(cfg.vocab_size))
    check(abs(losses[0] - uniform) <= TRAIN_LOSS_SLACK,
          f"train: step 0's loss {losses[0]} is not within {TRAIN_LOSS_SLACK} of ln(vocab) = {uniform}")
    stamps = [0.0] + [h["s"] for h in hist]
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    median_ms = statistics.median(step_ms[1:])
    batch, seq = 8, 256
    by = lambda t: sum(x.numel() * x.element_size() for x in tree.leaves(t))
    record = {"arch": cfg.name, "argv": TRAIN_ARGV, "batch": batch, "seq": seq, "params": sum(
        t.numel() for t in tree.leaves(params)), "state_bytes": {"params": by(params), "m": by(opt["m"]),
                                                                 "v": by(opt["v"])},
              "losses": losses, "grad_norms": [h["grad_norm"] for h in hist], "step_ms": step_ms,
              "median_step_ms_2_to_6": median_ms, "tokens_per_s": batch * seq / (median_ms / 1e3),
              "ln_vocab": uniform, "launcher_s": run["seconds"], "run_s": run_s, "held_bytes": held, "peak_bytes": peak,
              "coded_every": TRAIN_CODED_EVERY, "K": TRAIN_K,
              "snapshot": snap}
    ds = SyntheticLM(cfg)
    b = to_device(ds.batch(len(hist), batch, seq), dev)
    step = make_train_step(model, ocfg)
    step(params, opt, b)
    record["step_profile"] = profile_encode("train/step", lambda: step(params, opt, b), 1, top=8,
                                            kind=train_kernel_kind)
    # the optimizer alone, on gradients of the parameters' shapes and dtypes
    record["apply_updates_profile"] = profile_encode("train/apply_updates",
                                                     lambda: apply_updates(ocfg, params, params, opt), 1, top=4,
                                                     kind=train_kernel_kind)
    # the profiler slows the host: the busy time over an unprofiled step's wall estimates its busy share
    record["busy_share_of_median_step"] = record["step_profile"]["device_busy_ms"] / median_ms
    del run, state, params, opt, b
    torch.cuda.empty_cache()
    return record


def train_small_vs_cpu(dev) -> dict:
    """(b): the float32 smoke config, SMALL_TRAIN_STEPS steps on the card and
    on the CPU from the same parameters and batches."""
    check(not torch.backends.cuda.matmul.allow_tf32, "train/small: TF32 matmuls are on")
    model = build_model(smoke_config(TRAIN_ARCH).replace(dtype="float32"))
    cpu_params = model.init(torch.Generator().manual_seed(SEED + 1100))
    ds = SyntheticLM(model.cfg)
    step = make_train_step(model, RESUME_OPT)
    runs = {}
    for where, d in (("cpu", torch.device("cpu")), ("card", dev)):
        p = tree.map(lambda t: t.to(d), cpu_params)
        st = init_state(RESUME_OPT, p)
        losses, lrs = [], []
        for s in range(SMALL_TRAIN_STEPS):
            p, st, m = step(p, st, to_device(ds.batch(s, SMALL_TRAIN_BATCH, SMALL_TRAIN_SEQ), d))
            losses.append(float(m["loss"]))
            lrs.append(float(m["lr"]))
        check(all(t.device.type == d.type for t in tree.leaves((p, st))), f"train/small: the {where} run left {d}")
        runs[where] = (p, st, losses, lrs)
    (cp, cs, cl, lrs), (gp, gs, gl, _) = runs["cpu"], runs["card"]
    worst, tol = small_errors(gp, gs, gl, cp, cs, cl, lrs)
    record = {"config": model.cfg.name, "dtype": "float32", "steps": SMALL_TRAIN_STEPS,
              "batch": SMALL_TRAIN_BATCH, "seq": SMALL_TRAIN_SEQ, "tf32": False, "losses_cpu": cl,
              "losses_card": gl, "max_err": worst, "tolerance": tol}
    check(int(gs["step"]) == int(cs["step"]) == SMALL_TRAIN_STEPS
          and all(worst[k] <= tol[k] for k in worst), f"train/small: the card and the CPU differ: {record}")
    return record


def small_errors(gp, gs, gl, cp, cs, cl, lrs) -> tuple[dict, dict]:
    """The largest differences of a float32 smoke run's parameters, moments
    and losses (``gp``, ``gs``, ``gl``) from the CPU's (``cp``, ``cs``,
    ``cl``), and their tolerances (the ``SMALL_*`` constants; ``lrs`` the
    run's learning rates)."""
    bound_p = 2 * sum(lrs) * SMALL_STEP_SLACK + SMALL_TIGHT
    worst = {"params": 0.0, "params_share_beyond_tight": 0.0, "moments_of_scale": 0.0,
             "loss": max(abs(a - b) for a, b in zip(cl, gl))}
    for a, b in zip(tree.leaves(gp), tree.leaves(cp)):
        d = (a.cpu() - b).abs()
        worst["params"] = max(worst["params"], float(d.max()))
        worst["params_share_beyond_tight"] = max(worst["params_share_beyond_tight"],
                                                 float((d > SMALL_TIGHT).float().mean()))
    for a, b in zip(tree.leaves((gs["m"], gs["v"])), tree.leaves((cs["m"], cs["v"]))):
        worst["moments_of_scale"] = max(worst["moments_of_scale"],
                                        float((a.cpu() - b).abs().max() / b.abs().max().clamp_min(1e-30)))
    tol = {"params": bound_p, "params_share_beyond_tight": SMALL_FRACTION, "moments_of_scale": SMALL_MOMENT_SCALE,
           "loss": SMALL_LOSS_ATOL}
    return worst, tol


def train_resume(tcfg: dict, dev) -> dict:
    """(c): tests/test_system.py on the card at its own cut: six steps
    uninterrupted against three, a coded snapshot, the recovery of three
    lost replicas and three more, and against three, a disk checkpoint
    restored and three more, all bit for bit."""
    model = resume_model()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED + 1200))
    ostate = init_state(RESUME_OPT, params)
    step = make_train_step(model, RESUME_OPT)
    ds = SyntheticLM(model.cfg)

    def run(p, o, steps, start=0):
        for s in range(start, start + steps):
            p, o, _ = step(p, o, to_device(ds.batch(s, RESUME_BATCH, RESUME_SEQ), dev))
        return {"params": p, "opt": o}

    want = run(params, ostate, 6)
    again = run(params, ostate, 6)
    check(same_bits(again, want), "train/resume: two uninterrupted runs on the card differ")
    mid = run(params, ostate, 3)
    guard = CodedStateGuard(K=RESUME_K, device=dev)
    before = launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    guard.snapshot(mid, step=3)
    snapshot_ms = (time.perf_counter() - t0) * 1e3
    counted = check_launches("train_resume", "CodedStateGuard.snapshot", before, tcfg["runs"]["CodedStateGuard.snapshot"])
    check(guard._shards.shape == (RESUME_K, tcfg["S"]),
          f"train/resume: shards {guard._shards.shape}, not the {tcfg['S']} limbs phase 3 held")
    host_ms: list = []
    with timed(elastic, "recover_lost", host_ms):
        t0 = time.perf_counter()
        recovered, at = guard.fail_and_recover(RESUME_LOST)
        torch.cuda.synchronize()
        recover_ms = (time.perf_counter() - t0) * 1e3
    check(at == 3 and same_bits(recovered, mid), f"train/resume: fail_and_recover({RESUME_LOST}) is not bit-exact")
    check(same_bits(run(recovered["params"], recovered["opt"], 3, start=3), want),
          "train/resume: three steps after the coded recovery differ from the uninterrupted run")
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, mid, step=3)
        restored, at = restore_checkpoint(d, tcfg["spec"], device=dev)
    check(at == 3 and same_bits(restored, mid), "train/resume: the checkpoint restored other bits")
    check(same_bits(run(restored["params"], restored["opt"], 3, start=3), want),
          "train/resume: three steps after the disk restore differ from the uninterrupted run")
    return {"config": model.cfg.name, "cut": "n_layers=1 of the smoke config, tests/test_system.py's own",
            "opt": dataclasses.asdict(RESUME_OPT), "K": RESUME_K, "lost": RESUME_LOST,
            "state_bytes": spec_bytes(tcfg["spec"]), "limbs_a_replica": tcfg["S"], "launches": counted,
            "snapshot_ms": snapshot_ms, "recover_ms": recover_ms, "recover_lost_host_numpy_ms": host_ms[0],
            "deterministic_algorithms": torch.are_deterministic_algorithms_enabled(),
            "coded_resume_bit_exact": True, "disk_resume_bit_exact": True}


def train_phase(tcfg: dict, dev) -> tuple[dict, dict]:
    """Training (``tcfg`` from :func:`train_config`), counted on its own:
    (a) full width, (b) the card against the CPU, (c) the resumes. Returns
    (launches, record)."""
    gf_matmul_cuda.launches = 0
    butterfly_mac_rows_cuda.launches = 0
    record = {"full_width": train_full_width(tcfg, dev)}
    check(launches() == count_calls(tcfg["runs"][TRAIN_SNAPSHOT]),
          "train: the full-width run launched other hand kernels than its snapshot's")
    record["small_vs_cpu"] = train_small_vs_cpu(dev)
    record["resume"] = train_resume(tcfg, dev)
    counted = {"gf_matmul": gf_matmul_cuda.launches, "butterfly_mac": butterfly_mac_rows_cuda.launches}
    check(counted["gf_matmul"] > 0, "the train path never launched gf_matmul")
    record["launches"] = counted
    torch.cuda.empty_cache()
    return counted, record


# ---------------------------------------------------------------------------
# phase 9: the encode as real messages between ranks on the one card
# ---------------------------------------------------------------------------

RANKS_K = 8  # the reference's own mesh (tests/test_distributed.py:18)
RANKS_TIMEOUT_S = 120  # a rank's join and every gloo operation; the phase's deadline is a multiple
RANKS_REPS = 3  # timed calls a configuration on each rank (median), each after a barrier
RANKS_DEADLINE_S = 600  # the whole phase: a rank that has not answered by then fails the run


def ranks_configs() -> list[dict]:
    """The rank phase's configurations, host-side and picklable: the mesh,
    the entry point and its arguments, the payload a rank, the seed, the
    permutation budget, the matrix the encode computes (``target``) and the
    kernel calls each rank makes (``runs``, batch 1). K = 8 at 2^20 elements
    a processor, and the coded cells at their users' widths: LCC serving
    (N = 8: K = 6, R = 2) at the ``lcc_serve`` shard and the coded checkpoint
    (K = 16) at the ``coded_checkpoint`` replica."""
    f_m, f_n = Field(M31), Field(NTT)
    P = PAYLOAD
    A8 = np.asarray(random_matrix(f_m, RANKS_K, seed=SEED + 1001))
    A16 = np.asarray(random_matrix(f_m, 16, seed=SEED + 1002))
    lplan = build_lcc(SERVE_K, R=SERVE_R)
    cplan = build_parity_plan(CKPT_K)
    S_lcc = -(-limb_count(serve_spec()) // SERVE_K)
    S_ck = -(-limb_count(checkpoint_spec()) // CKPT_K)
    flat8, flat16 = ((8,), ("enc",), "enc"), ((16,), ("dp",), "dp")
    bf = plan_butterfly(RANKS_K, 1, NTT)
    rows = [
        # name, (mesh shape, axis names, encode axes), kind, q, A, p, pipeline, payload, seed
        ("ps_p1", flat8, "ps", M31, A8, 1, "", P, SEED + 1100),
        ("ps_p2", flat8, "ps", M31, A8, 2, "", P, SEED + 1200),
        ("butterfly", flat8, "butterfly", NTT, None, 1, "", P, SEED + 1300),
        ("butterfly_inverse", flat8, "butterfly_inverse", NTT, None, 1, "", P, None),
        ("hierarchical", ((4, 2), ("inter", "intra"), ("inter", "intra")), "hier", M31, A8, 1, "", P, SEED + 1400),
        ("multilevel", ((2, 2, 2), ("pod", "slice", "chip"), ("pod", "slice", "chip")), "ml", M31, A8, 1, "", P,
         SEED + 1500),
        ("pipelined", flat8, "ps", M31, A8, 1, "pipeline", P, SEED + 1600),
        ("allgather", flat8, "allgather", M31, A8, 1, "", P, SEED + 1700),
        ("lcc_serve", flat8, "lcc", NTT, None, 1, "", S_lcc, SEED + 1800),
        ("ps_16", flat16, "ps", M31, A16, 1, "", P, SEED + 1900),
        ("coded_checkpoint", flat16, "parity", M31, None, 1, "", S_ck, SEED + 2000),
        ("coded_checkpoint(4, 4)", ((4, 4), ("dcn", "ici"), ("dcn", "ici")), "parity", M31, None, 1, "", S_ck,
         SEED + 2000),
    ]
    cfgs = []
    for name, (shape, names, axes), kind, q, A, p, pipe, S, seed in rows:
        K = math.prod(shape)
        cfg = {"name": name, "world": K, "shape": shape, "names": names, "axes": axes, "kind": kind, "q": q,
               "A": A, "p": p, "pipeline": pipe, "S": S, "seed": seed, "limbs": kind in ("lcc", "parity"),
               "traced": name == "multilevel", "data_rows": K}
        if kind == "ps":
            plan = plan_prepare_shoot(K, p)
            ir = PIPELINES[pipe].apply(plan.to_ir(A, q=q), FullyConnected(K), 1 << 16) if pipe else plan.to_ir(A, q=q)
            cfg.update(ir=ir, budget=expected_permute_count(plan), target=A)
        elif kind in ("butterfly", "butterfly_inverse"):
            cfg.update(ir=bf.to_ir(inverse=kind == "butterfly_inverse"), budget=bf.H * bf.p,
                       target=butterfly_target_matrix(f_n, K, 2))
        elif kind == "hier":
            plan = plan_hierarchical(K, 1, 2)
            cfg.update(ir=plan.to_ir(A, q=q), budget=expected_hier_permute_count(plan), target=A)
        elif kind == "ml":
            plan = plan_multilevel(K, 1, (2, 2, 2))
            cfg.update(ir=plan.to_ir(A, q=q), budget=expected_multilevel_permute_count(plan), target=A)
        elif kind == "allgather":
            cfg.update(ir=None, budget=None, target=A)
        elif kind == "lcc":
            plan = plan_prepare_shoot(lplan.N, lplan.p)
            G = lcc_generator(lplan)
            cfg.update(ir=plan.to_ir(G, q=q), budget=expected_permute_count(plan), target=G, data_rows=lplan.K)
        else:  # the coded checkpoint's parity, flat or two-level
            plan = plan_prepare_shoot(K, 1) if len(shape) == 1 else plan_hierarchical(K, 1, shape[1])
            budget = expected_permute_count(plan) if len(shape) == 1 else expected_hier_permute_count(plan)
            cfg.update(ir=plan.to_ir(cplan.A, q=q), budget=budget, target=np.asarray(cplan.A))
        cfg["runs"] = {"rank": ir_kernel_calls(cfg["ir"], S, batch=1) if cfg["ir"] is not None else []}
        cfgs.append(cfg)
    return cfgs


# the entry point :func:`rank_fn` calls for each kind of configuration
RANK_ENTRIES = {"ps": "ps_encode_ranks", "butterfly": "butterfly_ranks", "butterfly_inverse": "butterfly_ranks",
                "hier": "hierarchical_encode_ranks", "ml": "multilevel_encode_ranks",
                "allgather": "allgather_encode_ranks", "lcc": "lcc_encode_ranks", "parity": "encode_parity_ranks"}


def rank_row(cfg: dict, k: int) -> np.ndarray:
    """Processor k's packet of a configuration, from the seed with numpy:
    residues below q, or 16-bit limbs on the coded paths; LCC's padding
    rows are zero."""
    if k >= cfg["data_rows"]:
        return np.zeros(cfg["S"], dtype=np.uint32)
    high = 1 << 16 if cfg["limbs"] else cfg["q"]
    return np.random.default_rng([cfg["seed"], k]).integers(0, high, size=cfg["S"], dtype=np.uint32)


def rank_fn(cfg: dict, mesh):
    """The rank entry point a user calls for the configuration."""
    kind, q, axes = cfg["kind"], cfg["q"], cfg["axes"]
    if kind == "ps":
        return ps_encode_ranks(mesh, axes, cfg["A"], p=cfg["p"], q=q, pipeline=cfg["pipeline"])[0]
    if kind in ("butterfly", "butterfly_inverse"):
        return butterfly_ranks(mesh, axes, q=q, inverse=kind == "butterfly_inverse")[0]
    if kind == "hier":
        return hierarchical_encode_ranks(mesh, *axes, cfg["A"], q=q)[0]
    if kind == "ml":
        return multilevel_encode_ranks(mesh, axes, cfg["A"], q=q)[0]
    if kind == "allgather":
        return allgather_encode_ranks(mesh, axes, cfg["A"], q=q)
    if kind == "lcc":
        return lcc_encode_ranks(mesh, axes, build_lcc(SERVE_K, R=SERVE_R))
    return encode_parity_ranks(mesh, axes, build_parity_plan(CKPT_K))


def one_card_fn(cfg: dict):
    """The one-card executor of the same configuration."""
    kind, q = cfg["kind"], cfg["q"]
    if kind == "ps":
        return ps_encode(cfg["A"], p=cfg["p"], q=q, pipeline=cfg["pipeline"])[0]
    if kind in ("butterfly", "butterfly_inverse"):
        return butterfly(cfg["world"], q=q, inverse=kind == "butterfly_inverse")[0]
    if kind == "hier":
        return hierarchical_encode(cfg["A"], k_intra=cfg["shape"][1], q=q)[0]
    if kind == "ml":
        return multilevel_encode(cfg["A"], cfg["shape"], q=q)[0]
    if kind == "allgather":
        return allgather_encode(cfg["A"], q=q)
    if kind == "lcc":
        return lcc_encode_collective(build_lcc(SERVE_K, R=SERVE_R))
    return encode_parity_collective(build_parity_plan(CKPT_K), cfg["shape"])


def row_hash(row: np.ndarray) -> str:
    return hashlib.blake2b(np.ascontiguousarray(row).view(np.uint8), digest_size=16).hexdigest()


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rank_run(cfg: dict, rank: int, dev, carried: dict) -> dict:
    """One configuration on this rank: the counted call, RANKS_REPS timed
    calls after barriers, and (IR configurations) one traced call, whose
    round spans give the wire part and whose LocalOp spans the device part."""
    mesh = make_mesh(cfg["shape"], cfg["names"], device=dev)
    k = mesh.index(cfg["axes"])
    if cfg["kind"] == "butterfly_inverse":
        x = carried.pop("butterfly")
    else:
        x = torch.from_numpy(rank_row(cfg, k).view(np.int32)).to(dev)[None]
    fn = rank_fn(cfg, mesh)
    dist.barrier()
    before = launches()
    out = fn(x)
    sync(dev)
    counted = tuple(a - b for a, b in zip(launches(), before))
    if cfg["name"] == "butterfly":
        carried["butterfly"] = out
    res = {"name": cfg["name"], "rank": rank, "k": k, "hash": row_hash(to_numpy(out)[0]),
           "launches": counted, "device": str(fn.device), "transport": fn.transport,
           "kernels": getattr(fn, "kernels", None), "permutes": getattr(fn, "permutes_run", None),
           "permute_count": getattr(fn, "permute_count", None)}
    walls = []
    for _ in range(RANKS_REPS):
        dist.barrier()
        sync(dev)
        t0 = time.perf_counter()
        fn(x)
        sync(dev)
        walls.append((time.perf_counter() - t0) * 1e3)
    res.update(wall_ms=statistics.median(walls), walls_ms=walls)
    if cfg["ir"] is not None:
        tracer = Tracer()
        topo = Hierarchy(levels=tuple(reversed(cfg["shape"]))) if len(cfg["shape"]) > 1 else None
        traced = ir_encode_ranks(mesh, cfg["axes"], fn.ir, q=cfg["q"], tracer=tracer, topo=topo,
                                 metrics=MetricsRegistry())
        same_out = same(traced(x), out)
        rounds = [s for s in tracer.spans if "comm_round" in s.attrs]
        res.update(
            traced_equal=same_out, traced_permutes=traced.permutes_run,
            traced_ms=next(s.dur_us for s in tracer.spans if s.name == "ir_encode") / 1e3,
            wire_ms=sum(s.dur_us for s in rounds) / 1e3,
            device_ms=sum(s.dur_us for s in tracer.spans if s.name.startswith("local[")) / 1e3,
            round_levels=[s.attrs.get("level") for s in rounds],
            round_ppermutes=sum(s.attrs["ppermutes"] for s in rounds))
    del out
    return res


def rank_worker(rank: int, world: int, init: str, cfgs: list, go, out, device_type: str):
    """A rank of the phase: joins the gloo group, says it is ready, waits for
    the parent's go, runs every configuration and sends each result. It
    computes on card 0 (``device_type`` "cuda") or, to rehearse the phase
    without a card, on the CPU."""
    try:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # every rank lives on this host
        dev = torch.device("cpu")
        if device_type == "cuda":
            torch.cuda.set_device(0)
            dev = torch.device("cuda", 0)
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=RANKS_TIMEOUT_S))
        torch.zeros(1, device=dev)  # the context, before the clock starts
        out.put(("ready", rank, None))
        if not go.wait(RANKS_DEADLINE_S):
            raise TimeoutError("the parent never said go")
        carried: dict = {}
        for cfg in cfgs:
            out.put(("ok", rank, rank_run(cfg, rank, dev, carried)))
        dist.destroy_process_group()
        out.put(("done", rank, None))
    except BaseException:  # reported to the parent, which fails the run
        out.put(("error", rank, traceback.format_exc()))


def rank_reference(cfg: dict, dev, carried: dict) -> tuple[list, dict]:
    """The parent's side of a configuration, on the card: the whole (K, S)
    input from the same seeds, the one-card executor's output, a plain
    ``x @ target mod q`` (the inverse butterfly: x itself), both equal, and
    each row's hash. Returns (row hashes, record)."""
    K = cfg["world"]
    if cfg["kind"] == "butterfly_inverse":
        x, want = carried.pop("butterfly")
    else:
        x = torch.from_numpy(np.stack([rank_row(cfg, k) for k in range(K)]).view(np.int32)).to(dev)
        want = None
    out = one_card_fn(cfg)(x)
    if cfg["kind"] == "butterfly":
        carried["butterfly"] = (out, x)
    if want is None:
        want = plain_matrix_encode(x, cfg["target"], cfg["q"])
    check(same(out, want), f"ranks/{cfg['name']}: the one-card executor != plain x @ A mod q on the card")
    host = to_numpy(out)
    del x, out, want
    return [row_hash(host[k]) for k in range(K)], {"checked_columns_plain_on_card": cfg["S"]}


def ranks_phase(cfgs: list[dict], dev) -> tuple[dict, dict]:
    """Every configuration on K ranks that share the card, counted on the
    ranks: one spawned pool for K = 8 and one for K = 16, started at once, so
    that their start-up overlaps the parent's references. Every rank's block
    must hash like the same row of the one-card executor's output (itself
    equal to a plain ``x @ A mod q``), every rank must run the budget, and
    both kernels must have run in the ranks. Returns (launches, record)."""
    import multiprocessing as mp

    t0 = time.perf_counter()
    ctx = mp.get_context("spawn")  # the parent has initialised CUDA: no fork
    pools, tmp = [], tempfile.TemporaryDirectory()
    try:
        for world in sorted({c["world"] for c in cfgs}):
            mine = [c for c in cfgs if c["world"] == world]
            go, out = ctx.Event(), ctx.Queue()
            init = "file://" + os.path.join(tmp.name, f"store{world}")
            procs = [ctx.Process(target=rank_worker, args=(r, world, init, mine, go, out, dev.type), daemon=True)
                     for r in range(world)]
            for p in procs:
                p.start()
            pools.append({"world": world, "cfgs": mine, "go": go, "out": out, "procs": procs})
        t_ref = time.perf_counter()
        refs, carried = {}, {}
        for cfg in cfgs:
            refs[cfg["name"]] = rank_reference(cfg, dev, carried)
            torch.cuda.empty_cache()
        ref_s = time.perf_counter() - t_ref
        results, pool_s, ready_s = {}, {}, {}
        for pool in pools:
            t_pool = time.perf_counter()
            pool["go"].set()
            want = pool["world"] * (len(pool["cfgs"]) + 2)  # ready, one per configuration, done
            got, deadline = 0, time.monotonic() + RANKS_DEADLINE_S
            while got < want:
                try:
                    status, rank, value = pool["out"].get(timeout=5)
                except queue.Empty:
                    dead = [r for r, p in enumerate(pool["procs"]) if p.exitcode not in (None, 0)]
                    check(not dead, f"ranks: rank(s) {dead} of the K={pool['world']} pool died")
                    check(time.monotonic() < deadline,
                          f"ranks: the K={pool['world']} pool did not finish within {RANKS_DEADLINE_S} s")
                    continue
                check(status != "error", f"ranks: rank {rank} of the K={pool['world']} pool raised:\n{value}")
                got += 1
                if status == "ok":
                    results.setdefault(value["name"], {})[rank] = value
                elif status == "ready":  # the last rank's join, from the phase's start
                    ready_s[pool["world"]] = time.perf_counter() - t0
            pool_s[pool["world"]] = time.perf_counter() - t_pool
    finally:
        for pool in pools:
            for p in pool["procs"]:
                if p.is_alive():
                    p.terminate()
            for p in pool["procs"]:
                p.join(30)
        tmp.cleanup()

    total = {"gf_matmul": 0, "butterfly_mac": 0}
    record = {}
    for cfg in cfgs:
        name, K = cfg["name"], cfg["world"]
        hashes, ref_record = refs[name]
        per = results[name]
        check(sorted(per) == list(range(K)), f"ranks/{name}: answers from ranks {sorted(per)}")
        check(sorted(v["k"] for v in per.values()) == list(range(K)), f"ranks/{name}: processor indices")
        expect = count_calls(cfg["runs"]["rank"])
        for rank, v in per.items():
            check(v["hash"] == hashes[v["k"]],
                  f"ranks/{name}: rank {rank}'s block != row {v['k']} of the one-card executor and plain x @ A")
            check(v["device"] == "cuda:0", f"ranks/{name}: rank {rank} ran on {v['device']}")
            check(v["launches"] == expect, f"ranks/{name}: rank {rank} launched (gf, bf)={v['launches']}, "
                                           f"expected {expect}")
            if cfg["ir"] is not None:
                check(v["kernels"] == "cuda" and v["transport"] == "gloo_exchange",
                      f"ranks/{name}: rank {rank} ran kernels={v['kernels']} over {v['transport']}")
                check(v["permutes"] == v["permute_count"] == cfg["budget"] == v["traced_permutes"]
                      == v["round_ppermutes"],
                      f"ranks/{name}: rank {rank} ran {v['permutes']} permutations, the budget is {cfg['budget']}")
                check(v["traced_equal"], f"ranks/{name}: rank {rank}'s traced call != its untraced call")
                if cfg["traced"]:
                    check(v["round_levels"] == [0, 1, 2], f"ranks/{name}: round levels {v['round_levels']}")
            total["gf_matmul"] += v["launches"][0]
            total["butterfly_mac"] += v["launches"][1]
        walls = [v["wall_ms"] for v in per.values()]
        rec = {"K": K, "mesh": dict(zip(cfg["names"], cfg["shape"])), "q": cfg["q"], "p": cfg["p"],
               "payload_elems": cfg["S"], "entry": RANK_ENTRIES[cfg["kind"]], "budget": cfg["budget"],
               "kernel_calls_a_rank": [f"{kk} {sh}" for kk, sh in cfg["runs"]["rank"]],
               "launches": {"gf_matmul": sum(v["launches"][0] for v in per.values()),
                            "butterfly_mac": sum(v["launches"][1] for v in per.values())},
               "wall_ms_median_over_ranks": statistics.median(walls), "wall_ms_max_over_ranks": max(walls),
               **ref_record, "bit_exact_ranks": K}
        if cfg["ir"] is not None:
            r0 = per[0]
            rec.update(rank0_traced_ms=r0["traced_ms"], rank0_wire_ms=r0["wire_ms"], rank0_device_ms=r0["device_ms"],
                       wire_ms_median_over_ranks=statistics.median(v["wire_ms"] for v in per.values()),
                       device_ms_median_over_ranks=statistics.median(v["device_ms"] for v in per.values()))
        record[name] = rec
    for k, n in total.items():
        check(n > 0, f"the rank path never launched {k}")
    record["seconds"] = {"phase": time.perf_counter() - t0, "references": ref_s,
                         **{f"K{w}_ready_after": s for w, s in ready_s.items()},
                         **{f"K{w}_after_go": s for w, s in pool_s.items()}}
    record["wire"] = "gloo over loopback TCP between processes on one host, staged through pinned host memory"
    return total, record

# ---------------------------------------------------------------------------
# phase 10: the MoE family at the full width of Snowflake Arctic
# ---------------------------------------------------------------------------

MOE_ARCH = "arctic-480b"
# Depth cut from 35 to 2 layers, no width cut: one layer holds 27.2 GB of
# bf16 weights, so two (with embed and lm_head) come to 55.4 GB and a third
# would leave under 3 GB of the card for the context, the activations and
# the guard.
MOE_LAYERS = 2
MOE_LAYER_BYTES = 27_224_207_360  # experts, attention, dense residual, float32 router, norms
MOE_HELD_MAX = 1 << 30  # what earlier phases may still hold on the card as the phase starts
MOE_GATHER = profile_with("gather", moe_gather=True)
MOE_FORMS_PLEN = 500  # prompt of the direct scatter-versus-gather check (bucket 512, where capacity drops)
# (d): the float32 smoke config on the card against the CPU
MOE_SMALL_TOKENS, MOE_SMALL_STEPS, MOE_SMALL_PLEN, MOE_SMALL_BUCKET = (2, 24), 4, 30, 32


def moe_config() -> dict:
    """Phase 10's configuration, host-side: Arctic cut to MOE_LAYERS layers,
    the engine state's spec and shard width, the guard's plan and the kernel
    call of one snapshot (``runs``)."""
    cfg = get(MOE_ARCH).replace(n_layers=MOE_LAYERS)
    model = build_model(cfg)
    spec = serve_state_spec(model)
    plan = build_lcc(SERVE_K, R=SERVE_R)
    lps = plan_prepare_shoot(plan.N, plan.p)
    S = -(-limb_count(spec) // SERVE_K)
    return {"name": "moe", "q": NTT, "K": SERVE_K, "S": S, "spec": spec, "plan": plan, "model": model,
            "runs": {"ContinuousEngine.serve(guard)": in_blocks(lambda w: [("gf_matmul", (plan.N, lps.n, lps.m, w))], S, plan.N)}}


@contextlib.contextmanager
def routed(sink: list):
    """Keep the (T, k) expert choices of every ``moe_block`` call made while
    the block runs, on the device (no host sync), in call order."""
    route = model_layers.moe_route

    def keep(router, xt, cfg):
        out = route(router, xt, cfg)
        sink.append(out[2].detach())
        return out

    model_layers.moe_route = keep
    try:
        yield
    finally:
        model_layers.moe_route = route


def drops(eidx: torch.Tensor, cfg) -> int:
    """(token, slot) pairs of one ``moe_block`` call past their expert's
    capacity (the block drops them)."""
    load = torch.bincount(eidx.reshape(-1), minlength=cfg.moe.n_experts)
    return int((load - model_layers.moe_capacity(eidx.shape[0], cfg)).clamp_min(0).sum())


def moe_drops(choices: list, cfg, layers: int = MOE_LAYERS, what: str = "moe") -> dict:
    """Drops in each prefill (its ``layers`` MoE calls summed) and in the
    decode ticks (T = the slot count: none may drop) of one serve."""
    prefills, ticks = [], []
    i = 0
    while i < len(choices):
        T = choices[i].shape[0]
        group = choices[i: i + layers]
        check(len(group) == layers and all(c.shape[0] == T for c in group), f"{what}: a call is missing its layers")
        (ticks if T == SERVE_SLOTS else prefills).append({"tokens": T, "dropped": sum(drops(c, cfg) for c in group)})
        i += layers
    check(all(t["dropped"] == 0 for t in ticks), f"{what}: a decode tick dropped a (token, slot) pair")
    return {"prefills": prefills, "decode_calls": len(ticks), "decode_dropped": 0}


def index_add_combine(contrib, st, T: int, k: int):
    """``moe_block``'s combine as it was before its fixed order: a float32
    ``index_add`` onto zero (atomics on the card, in whatever order they
    land; the same bits as the fixed order for top-k <= 2)."""
    return torch.zeros((T, contrib.shape[1]), dtype=torch.float32, device=contrib.device).index_add(
        0, st, contrib.float())


@contextlib.contextmanager
def combine_as(fn):
    """Run ``moe_block`` with ``fn`` as its combine while the block runs
    (``None``: its own)."""
    own = model_layers._combine
    model_layers._combine = fn or own
    try:
        yield
    finally:
        model_layers._combine = own


def moe_forms(model, params, dev, forms: dict, what: str = "moe") -> dict:
    """(b)'s direct check: one MOE_FORMS_PLEN-token prompt prefilled at
    bucket 512 (where capacity drops pairs) into slot 0, then one decode tick
    of every slot, under each form's rules and combine (``forms``: name →
    (rules, combine or ``None`` for ``moe_block``'s own), the first the
    scatter form): the last logits of every form equal the first's."""
    V = model.cfg.vocab_size
    prompt = np.random.default_rng(SEED + 1102).integers(1, V, size=MOE_FORMS_PLEN).astype(np.int32)
    bucket = bucket_for(MOE_FORMS_PLEN, SERVE_BUCKETS)
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :MOE_FORMS_PLEN] = prompt
    toks = torch.from_numpy(toks).to(dev)
    nxt = torch.from_numpy(np.random.default_rng(SEED + 1103).integers(1, V, size=(SERVE_SLOTS, 1))
                           .astype(np.int32)).to(dev)
    pos = torch.tensor([MOE_FORMS_PLEN] + [0] * (SERVE_SLOTS - 1), dtype=torch.int32, device=dev)
    out = {}
    for form, (r, combine) in forms.items():
        cache = model.init_cache(SERVE_SLOTS, SERVE_POSITIONS, device=dev)
        with combine_as(combine):
            last, cache = make_prefill_step(model, into_cache=True, rules=r)(params, cache, toks, 0, MOE_FORMS_PLEN)
            lg, _ = make_decode_step(model, rules=r)(params, cache, nxt, pos)
        out[form] = (last[0, :V], lg[:, 0, :V])
        check(bool(torch.isfinite(last).all() and torch.isfinite(lg).all()), f"{what}/forms: {form} logits not finite")
    first, (pa, da) = next(iter(out.items()))
    rec = {"plen": MOE_FORMS_PLEN, "bucket": bucket, "against": first}
    for form, (pb, db) in list(out.items())[1:]:
        rec[form] = {"prefill_last_logits_max_abs_diff": float((pa - pb).abs().max()),
                     "decode_logits_max_abs_diff": float((da - db).abs().max()),
                     "equal": bool(torch.equal(pa, pb) and torch.equal(da, db))}
        check(rec[form]["equal"], f"{what}/forms: the {form} logits differ from the {first} form's: {rec}")
    return rec


def moe_small_vs_cpu(dev) -> dict:
    """(d): the float32 smoke config of the same architecture on the card
    against the CPU (:func:`small_vs_cpu`)."""
    return small_vs_cpu(smoke_config(MOE_ARCH).replace(dtype="float32"), dev, SEED + 1104, "moe/small")


def small_vs_cpu(cfg, dev, seed: int, what: str, steps: int = MOE_SMALL_STEPS) -> dict:
    """A float32 smoke config on the card against the CPU, from the same
    parameters: ``forward``, ``steps`` ``decode_step``s and, where the model
    has one, ``prefill_into_cache`` at a bucket where capacity drops, logits
    within SMALL_LOGITS_ATOL; the router's expert choices of every call
    equal; ``loss`` and its terms (``mtp_ce`` among them with MTP) within
    SMALL_LOSS_ATOL. An encoder-decoder's batch carries frames and its
    decode cache their encoding; a VLM's batch carries patches."""
    check(not torch.backends.cuda.matmul.allow_tf32, f"{what}: TF32 matmuls are on")
    model = build_model(cfg)
    cpu_params = model.init(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed + 1)
    toks = rng.integers(0, cfg.vocab_size, size=MOE_SMALL_TOKENS).astype(np.int32)
    step_toks = rng.integers(0, cfg.vocab_size, size=(steps, 3, 1)).astype(np.int32)
    tb = np.zeros((1, MOE_SMALL_BUCKET), np.int32)
    tb[0, :MOE_SMALL_PLEN] = rng.integers(1, cfg.vocab_size, size=MOE_SMALL_PLEN)
    extra, dec_frames = {}, None  # drawn last: a config without them draws what it drew before
    if cfg.encdec is not None:
        extra["frames"] = rng.normal(size=(toks.shape[0], cfg.encdec.n_frames, cfg.d_model)).astype(np.float32)
        dec_frames = rng.normal(size=(3, cfg.encdec.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.vlm is not None:
        extra["patches"] = rng.normal(size=(toks.shape[0], cfg.vlm.n_patches, cfg.d_model)).astype(np.float32)
    runs, losses = {}, {}
    for where, d in (("cpu", torch.device("cpu")), ("card", dev)):
        p = tree.map(lambda t: t.to(d), cpu_params)
        choices: list = []
        batch = {"tokens": torch.from_numpy(toks).to(d), **{k: torch.from_numpy(v).to(d) for k, v in extra.items()}}
        with routed(choices):
            out = [model.forward(p, batch)[0]]
            cache = model.init_cache(3, 64, device=d)
            if dec_frames is not None:
                cache["enc_out"].copy_(model._encode_frames(p, torch.from_numpy(dec_frames).to(d)))
            dec = []
            for t in range(steps):
                lg, cache = model.decode_step(p, cache, torch.from_numpy(step_toks[t]).to(d),
                                              torch.tensor([t, 2 * t, 5], dtype=torch.int32, device=d))
                dec.append(lg)
            out.append(torch.stack(dec))
            if model.supports_prefill:
                out.append(model.prefill_into_cache(p, model.init_cache(3, 64, device=d), torch.from_numpy(tb).to(d),
                                                    1)[0])
        runs[where] = ([o.cpu() for o in out], [c.cpu() for c in choices])
        losses[where] = {k: float(v) for k, v in model.loss(p, batch | {"labels": batch["tokens"]})[1].items()}
    errs = {k: float((a - b)[..., : cfg.vocab_size].abs().max())
            for k, a, b in zip(("forward", "decode_step", "prefill_into_cache"), runs["cpu"][0], runs["card"][0])}
    (cc, gc) = runs["cpu"][1], runs["card"][1]
    pairs = sum(c.numel() for c in cc)
    equal = sum(int((a == b).sum()) for a, b in zip(cc, gc)) if len(cc) == len(gc) else 0
    rec = {"config": cfg.name, "dtype": "float32", "tf32": False, "decode_steps": steps, "logits_max_abs_err": errs,
           "tolerance": SMALL_LOGITS_ATOL, "router_calls": len(cc), "router_choices": pairs,
           "router_choices_equal": equal,
           "loss_cpu": losses["cpu"], "loss_card": losses["card"], "loss_tolerance": SMALL_LOSS_ATOL,
           "loss_max_abs_err": max(abs(losses["cpu"][k] - losses["card"][k]) for k in losses["cpu"])}
    if model.supports_prefill:
        rec["capacity_drops_in_prefill"] = sum(drops(c, cfg) for c in cc[-model.repeats * len(model.body):])
    check(all(e <= SMALL_LOGITS_ATOL for e in errs.values()), f"{what}: card and CPU logits differ: {rec}")
    check(len(cc) == len(gc) and equal == pairs, f"{what}: the router chose other experts on the card: {rec}")
    terms = ["aux", "ce", "loss"] + (["mtp_ce"] if cfg.mtp else [])
    check(sorted(losses["card"]) == sorted(losses["cpu"]) == terms and rec["loss_max_abs_err"] <= SMALL_LOSS_ATOL,
          f"{what}: the card's loss and its terms differ from the CPU's: {rec}")
    return rec


def moe_phase(mcfg: dict, dev) -> tuple[dict, dict]:
    """The MoE family at Arctic's full width, MOE_LAYERS layers deep
    (``mcfg`` from :func:`moe_config`), counted on its own: (a) greedy under
    the baseline rules (scatter dispatch), (b) greedy under the
    ``moe_gather`` profile's rules, equal to (a), and the two forms' logits
    on one prefill and one tick, (c) greedy under the guard with one kill,
    equal to (a), (d) the float32 smoke config on the card against the CPU.
    Returns (launches, record)."""
    model = mcfg["model"]
    cfg = model.cfg
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    check(held < MOE_HELD_MAX, f"moe: earlier phases still hold {held} bytes of the card")
    free_bytes, total_bytes = torch.cuda.mem_get_info()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1100)
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    by = lambda t: sum(x.numel() * x.element_size() for x in tree.leaves(t))  # noqa: E731
    mc = cfg.moe
    check(cfg.d_model == 7168 and cfg.n_heads == 56 and cfg.n_kv_heads == 8 and cfg.head_dim == 128
          and mc.n_experts == 128 and mc.top_k == 2 and mc.expert_ff == 4864 and mc.dense_residual_ff == 4864
          and cfg.vocab_size == 32000 and mc.capacity_factor == 1.25 and cfg.n_layers == MOE_LAYERS
          and tuple(params["body"]["b0"]["moe"]["w_gate"].shape) == (MOE_LAYERS, 128, 7168, 4864),
          "moe: not Arctic's width")
    check(all(t.is_cuda for t in tree.leaves(params)) and params["body"]["b0"]["moe"]["router"].dtype == torch.float32
          and all(t.dtype == torch.bfloat16 for k, t in tree.flatten_with_names(params).items()
                  if not k.endswith("router")), "moe: the weights are not bf16 (a float32 router) on the card")
    check(by(params["body"]) == MOE_LAYERS * MOE_LAYER_BYTES, f"moe: the body holds {by(params['body'])} bytes")
    shape = ShapeSpec("moe", "decode", SERVE_POSITIONS, SERVE_SLOTS)
    rules = {"scatter": rules_for(cfg, shape, BASELINE), "gather": rules_for(cfg, shape, MOE_GATHER)}
    check(not rules["scatter"].has("moe_gather") and rules["gather"].has("moe_gather"), "moe: the rules' flags")
    trace = poisson_trace(SERVE_REQUESTS, SERVE_RATE, mix=SERVE_MIX, max_new_tokens=SERVE_MAX_NEW,
                          vocab_size=cfg.vocab_size, seed=SEED + 1001)
    engines = {form: ContinuousEngine(model, params, n_slots=SERVE_SLOTS, max_len=SERVE_POSITIONS,
                                      buckets=SERVE_BUCKETS, max_new_tokens=SERVE_MAX_NEW, metrics=MetricsRegistry(),
                                      rules=r) for form, r in rules.items()}
    weights_but_embed = by(params) - by(params["embed"])
    record = {"arch": cfg.name, "layers": f"{MOE_LAYERS} of {get(MOE_ARCH).n_layers}",
              "params": sum(t.numel() for t in tree.leaves(params)), "param_bytes": by(params),
              "layer_bytes": MOE_LAYER_BYTES, "held_bytes": held, "free_bytes_at_start": free_bytes,
              "total_bytes": total_bytes, "init_s": init_s, "init_peak_bytes": init_peak,
              "slots": SERVE_SLOTS, "max_len": SERVE_POSITIONS, "buckets": SERVE_BUCKETS, "max_new": SERVE_MAX_NEW,
              "sync_every": SERVE_SYNC, "trace": {"requests": len(trace), "rate_rps": SERVE_RATE, "seed": SEED + 1001},
              "capacity": {"factor": mc.capacity_factor, "decode": model_layers.moe_capacity(SERVE_SLOTS, cfg),
                           **{f"prefill_{b}": model_layers.moe_capacity(b, cfg) for b in SERVE_BUCKETS}},
              "decode_tick_bound": {"bytes": weights_but_embed, "ms": weights_but_embed / HBM_BYTES_PER_S * 1e3,
                                    "what": "every weight but embed read once a tick"},
              "guard": {"K": SERVE_K, "R": SERVE_R, "q": NTT, "kills": SERVE_ENGINE_KILL,
                        "state_bytes": spec_bytes(mcfg["spec"]), "limbs_a_shard": mcfg["S"],
                        "gf_matmul_shape": mcfg["runs"]["ContinuousEngine.serve(guard)"][0][1]}}

    gf_matmul_cuda.launches = 0
    butterfly_mac_rows_cuda.launches = 0
    choices: list = []
    with routed(choices):
        rep_a = engines["scatter"].serve(trace, greedy=True, sync_every=SERVE_SYNC)  # (a)
    greedy = tokens_of(rep_a)
    record["greedy"] = check_report("moe/greedy", rep_a, trace, cfg.vocab_size)
    record["capacity_drops"] = moe_drops(choices, cfg)
    del choices
    check(launches() == (0, 0), "moe: the unguarded run launched a hand kernel")
    rep_b = engines["gather"].serve(trace, greedy=True, sync_every=SERVE_SYNC)  # (b)
    record["gather"] = check_report("moe/gather", rep_b, trace, cfg.vocab_size)
    record["gather"]["tokens_equal_scatter"] = tokens_of(rep_b) == greedy
    check(record["gather"]["tokens_equal_scatter"],
          "moe: the gather form's greedy tokens differ from the scatter form's")
    with combine_as(index_add_combine):  # the combine before its fixed order: the same tokens at top-2
        rep_ia = engines["scatter"].serve(trace, greedy=True, sync_every=SERVE_SYNC)
    record["gather"]["tokens_equal_index_add_combine"] = tokens_of(rep_ia) == greedy
    check(record["gather"]["tokens_equal_index_add_combine"],
          "moe: the fixed-order combine's greedy tokens differ from the index_add combine's")
    record["forms"] = moe_forms(model, params, dev, {"scatter": (rules["scatter"], None),
                                                      "gather": (rules["gather"], None),
                                                      "index_add": (rules["scatter"], index_add_combine)})
    rep_c, record["greedy_guarded"] = guarded_run(mcfg, engines["scatter"], trace, dev, collective=False,  # (c)
                                                  greedy=True)
    check(tokens_of(rep_c) == greedy, "moe: greedy tokens after a kill and recovery differ from the unfailed run's")
    counted = {"gf_matmul": gf_matmul_cuda.launches, "butterfly_mac": butterfly_mac_rows_cuda.launches}
    check(counted["gf_matmul"] > 0, "the MoE serve path never launched gf_matmul")
    record["launches"] = counted
    record["peak_bytes"] = torch.cuda.max_memory_allocated()
    record.update(serve_timings(model, params, engines["scatter"], trace, dev, kind=train_kernel_kind, what="moe"))
    record["decode_tick_share_of_bound"] = record["decode_tick_bound"]["ms"] / record["decode_tick_ms"]
    del params, engines
    torch.cuda.empty_cache()
    record["small_vs_cpu"] = moe_small_vs_cpu(dev)  # (d)
    torch.cuda.empty_cache()
    record["seconds"] = time.perf_counter() - t_phase
    return counted, record


# ---------------------------------------------------------------------------
# phase 11: MLA, the layer prefix and MTP at the full width of DeepSeek-V3
# ---------------------------------------------------------------------------

MLA_ARCH = "deepseek-v3-671b"
# Depth cut from 61 to 4 layers, no width cut: the 3 dense prefix layers
# (first_dense) and one MoE layer, with the MTP head, come to 53.4 GB of bf16
# weights; a fifth layer would make 76.5 GB and leave too little of the card
# for the init's slabs, a 512-token prefill's float32 logits and the guard.
MLA_LAYERS = 4
MLA_PARAM_BYTES = 53_449_664_512  # embed, lm_head, 3 dense MLA layers, one MLA-MoE layer, MTP (its own MLA-MoE layer)
MLA_MTP_BYTES = 23_223_791_616  # never read when serving
MLA_TOP8 = dict(n_experts=16, top_k=8)  # (d)'s top-8 variant of the smoke config


def mla_config() -> dict:
    """Phase 11's configuration, host-side: DeepSeek-V3 cut to MLA_LAYERS
    layers, the engine state's spec and shard width (prefix caches beside
    the stacked body's), the guard's plan and the kernel call of one
    snapshot (``runs``)."""
    cfg = get(MLA_ARCH).replace(n_layers=MLA_LAYERS)
    model = build_model(cfg)
    spec = serve_state_spec(model)
    plan = build_lcc(SERVE_K, R=SERVE_R)
    lps = plan_prepare_shoot(plan.N, plan.p)
    S = -(-limb_count(spec) // SERVE_K)
    return {"name": "mla", "q": NTT, "K": SERVE_K, "S": S, "spec": spec, "plan": plan, "model": model,
            "runs": {"ContinuousEngine.serve(guard)": in_blocks(lambda w: [("gf_matmul", (plan.N, lps.n, lps.m, w))], S, plan.N)}}


def mla_small_vs_cpu(dev) -> dict:
    """(d): the float32 smoke config and its top-8 variant (MLA_TOP8) on the
    card against the CPU, ``loss`` with ``mtp_ce`` included
    (:func:`small_vs_cpu`)."""
    cfg = smoke_config(MLA_ARCH).replace(dtype="float32")
    top8 = cfg.replace(name=f"{cfg.name}-top8", moe=dataclasses.replace(cfg.moe, **MLA_TOP8))
    return {"smoke": small_vs_cpu(cfg, dev, SEED + 1204, "mla/small"),
            "top8": small_vs_cpu(top8, dev, SEED + 1206, "mla/small_top8")}


def mla_phase(mcfg: dict, dev) -> tuple[dict, dict]:
    """DeepSeek-V3 at full width, MLA_LAYERS layers deep (``mcfg`` from
    :func:`mla_config`), counted on its own: (a) greedy under the baseline
    rules (scatter dispatch), (b) greedy under the ``moe_gather`` profile's
    rules, equal to (a), and on one prefill and one tick the logits of both
    forms and of the scatter form run again, bit-equal, (c) greedy under the
    guard with one kill, equal to (a), (d) the float32 smoke config and its
    top-8 variant on the card against the CPU. Returns (launches, record)."""
    model = mcfg["model"]
    cfg = model.cfg
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    check(held < MOE_HELD_MAX, f"mla: earlier phases still hold {held} bytes of the card")
    free_bytes, total_bytes = torch.cuda.mem_get_info()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1200)
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    by = lambda t: sum(x.numel() * x.element_size() for x in tree.leaves(t))  # noqa: E731
    mc, ml = cfg.moe, cfg.mla
    mla_widths = (ml.q_lora_rank, ml.kv_lora_rank, ml.qk_nope_head_dim, ml.qk_rope_head_dim, ml.v_head_dim)
    check(cfg.d_model == 7168 and cfg.n_heads == 128 and mla_widths == (1536, 512, 128, 64, 128)
          and mc.n_experts == 256 and mc.top_k == 8 and mc.expert_ff == 2048 and mc.shared_ff == 2048
          and mc.first_dense == 3 and mc.dense_ff == 18432 and cfg.vocab_size == 129280 and cfg.mtp
          and cfg.n_layers == MLA_LAYERS and (model.prefix, model.body, model.repeats) == (["mla_dense"] * 3,
                                                                                         ["mla_moe"], 1)
          and tuple(params["body"]["b0"]["moe"]["w_gate"].shape) == (1, 256, 7168, 2048)
          and tuple(params["mtp"]["block"]["moe"]["w_gate"].shape) == (256, 7168, 2048)
          and tuple(params["prefix_0"]["mlp"]["w_up"].shape) == (7168, 18432), "mla: not DeepSeek-V3's width")
    check(all(t.is_cuda for t in tree.leaves(params))
          and all(t.dtype == (torch.float32 if k.endswith("router") else torch.bfloat16)
                  for k, t in tree.flatten_with_names(params).items()),
          "mla: the weights are not bf16 (float32 routers) on the card")
    check(by(params) == MLA_PARAM_BYTES and by(params["mtp"]) == MLA_MTP_BYTES,
          f"mla: the weights hold {by(params)} bytes")
    shape = ShapeSpec("mla", "decode", SERVE_POSITIONS, SERVE_SLOTS)
    rules = {"scatter": rules_for(cfg, shape, BASELINE), "gather": rules_for(cfg, shape, MOE_GATHER)}
    check(not rules["scatter"].has("moe_gather") and rules["gather"].has("moe_gather"), "mla: the rules' flags")
    trace = poisson_trace(SERVE_REQUESTS, SERVE_RATE, mix=SERVE_MIX, max_new_tokens=SERVE_MAX_NEW,
                          vocab_size=cfg.vocab_size, seed=SEED + 1001)
    engines = {form: ContinuousEngine(model, params, n_slots=SERVE_SLOTS, max_len=SERVE_POSITIONS,
                                      buckets=SERVE_BUCKETS, max_new_tokens=SERVE_MAX_NEW, metrics=MetricsRegistry(),
                                      rules=r) for form, r in rules.items()}
    tick_bytes = by(params) - by(params["embed"]) - by(params["mtp"])
    record = {"arch": cfg.name, "layers": f"{MLA_LAYERS} of {get(MLA_ARCH).n_layers} (3 dense prefix, 1 MoE) + MTP",
              "params": sum(t.numel() for t in tree.leaves(params)), "param_bytes": by(params),
              "mtp_bytes": by(params["mtp"]), "held_bytes": held, "free_bytes_at_start": free_bytes,
              "total_bytes": total_bytes, "init_s": init_s, "init_peak_bytes": init_peak,
              "slots": SERVE_SLOTS, "max_len": SERVE_POSITIONS, "buckets": SERVE_BUCKETS, "max_new": SERVE_MAX_NEW,
              "sync_every": SERVE_SYNC, "trace": {"requests": len(trace), "rate_rps": SERVE_RATE, "seed": SEED + 1001},
              "capacity": {"factor": mc.capacity_factor, "decode": model_layers.moe_capacity(SERVE_SLOTS, cfg),
                           **{f"prefill_{b}": model_layers.moe_capacity(b, cfg) for b in SERVE_BUCKETS}},
              "decode_tick_bound": {"bytes": tick_bytes, "ms": tick_bytes / HBM_BYTES_PER_S * 1e3,
                                    "what": "every weight but embed and mtp read once a tick"},
              "cache_bytes": by(mcfg["spec"][0]),
              "guard": {"K": SERVE_K, "R": SERVE_R, "q": NTT, "kills": SERVE_ENGINE_KILL,
                        "state_bytes": spec_bytes(mcfg["spec"]), "limbs_a_shard": mcfg["S"],
                        "gf_matmul_shape": mcfg["runs"]["ContinuousEngine.serve(guard)"][0][1]}}

    gf_matmul_cuda.launches = 0
    butterfly_mac_rows_cuda.launches = 0
    choices: list = []
    with routed(choices):
        rep_a = engines["scatter"].serve(trace, greedy=True, sync_every=SERVE_SYNC)  # (a)
    greedy = tokens_of(rep_a)
    record["greedy"] = check_report("mla/greedy", rep_a, trace, cfg.vocab_size)
    record["capacity_drops"] = moe_drops(choices, cfg, layers=model.repeats * len(model.body), what="mla")
    del choices
    check(launches() == (0, 0), "mla: the unguarded run launched a hand kernel")
    rep_b = engines["gather"].serve(trace, greedy=True, sync_every=SERVE_SYNC)  # (b)
    record["gather"] = check_report("mla/gather", rep_b, trace, cfg.vocab_size)
    record["gather"]["tokens_equal_scatter"] = tokens_of(rep_b) == greedy
    check(record["gather"]["tokens_equal_scatter"],
          "mla: the gather form's greedy tokens differ from the scatter form's")
    record["forms"] = moe_forms(model, params, dev, {"scatter": (rules["scatter"], None),
                                                      "gather": (rules["gather"], None),
                                                      "scatter_again": (rules["scatter"], None)}, what="mla")
    rep_c, record["greedy_guarded"] = guarded_run(mcfg, engines["scatter"], trace, dev, collective=False,  # (c)
                                                  greedy=True)
    check(tokens_of(rep_c) == greedy, "mla: greedy tokens after a kill and recovery differ from the unfailed run's")
    counted = {"gf_matmul": gf_matmul_cuda.launches, "butterfly_mac": butterfly_mac_rows_cuda.launches}
    check(counted["gf_matmul"] > 0, "the MLA serve path never launched gf_matmul")
    record["launches"] = counted
    record["peak_bytes"] = torch.cuda.max_memory_allocated()
    record.update(serve_timings(model, params, engines["scatter"], trace, dev, kind=train_kernel_kind, what="mla"))
    record["decode_tick_share_of_bound"] = record["decode_tick_bound"]["ms"] / record["decode_tick_ms"]
    del params, engines
    torch.cuda.empty_cache()
    record["small_vs_cpu"] = mla_small_vs_cpu(dev)  # (d)
    torch.cuda.empty_cache()
    record["seconds"] = time.perf_counter() - t_phase
    return counted, record


# ---------------------------------------------------------------------------
# phase 12: the SSM families at full width, RWKV6-3B and Jamba at cut depths
# ---------------------------------------------------------------------------

RWKV_ARCH, JAMBA_ARCH = "rwkv6-3b", "jamba-v0.1-52b"
# Every width kept, the depth cut to keep the script's time (each refeed tick
# is launch-bound, so a tick's time goes with the layer count): RWKV6-3B to
# 4 of its 32 layers (1.3 GB of bf16 weights; cut from 16 when phase
# coded_mesh was added, from 8 when phase moe_mesh was), Jamba to one of its four periods of 8 (the reference
# asserts whole periods; 26.6 GB).
RWKV_LAYERS, JAMBA_LAYERS = 4, 8
SSM_PARAM_BYTES = {RWKV_ARCH: 1_309_742_080, JAMBA_ARCH: 26_593_062_848}
SSM_MAX_LEN = 512  # the fixed Engine's max_len: the longest prompt + SERVE_MAX_NEW fits
SSM_SNAPSHOT_TICK = 40  # the guard's snapshot, mid-prompt (every prompt is longer)
SSM_LOST_TICKS = 4  # ticks refed after the snapshot, lost with host 3
# (b) resumes the refeed from the recovered state until the shortest prompt's
# request has all its new tokens (tick 106 of 457 here), not to the end: a
# tick is launch-bound (21-34 us of host time a kernel), and (a) already runs
# the whole refeed twice a model
SSM_KILL_HOST = 3
SSM_SCAN_TOKENS, SSM_SCAN_ROWS = 64, 2  # (c): one full-sequence call against that many decode calls
# (c): a layer's float32 full-sequence form against its decode form (the same
# step arithmetic; products of other row counts sum in other orders): the
# largest error within this share of the largest output
SSM_SCAN_REL_TOL = 1e-4
SSM_FORWARD_TOL = 0.15  # (c): bf16 forward against the refeed, rtol = atol (tests/test_models_smoke.py:82)
SSM_TICK_CHUNK = 4  # decode ticks in the profiled chunk
SSM_SMALL_STEPS = 8


def ssm_prompts(vocab: int) -> list[list[int]]:
    """The first FIXED_PROMPTS prompts of the serve phase's trace (its seed
    and length bands) over ``vocab``."""
    trace = poisson_trace(SERVE_REQUESTS, SERVE_RATE, mix=SERVE_MIX, max_new_tokens=SERVE_MAX_NEW, vocab_size=vocab,
                          seed=SEED + 1001)
    return [r.prompt for r in trace[:FIXED_PROMPTS]]


def refeed_config(name: str, cfgs) -> dict:
    """A refeed phase's configuration, host-side: for each (arch, config) of
    ``cfgs``, the model, its prompts, the spec of the state the guard
    snapshots (the fixed engine's cache at SSM_MAX_LEN, the token buffer and
    the position) and its shard width, and the kernel call of one snapshot
    of each (``runs``)."""
    plan = build_lcc(SERVE_K, R=SERVE_R)
    lps = plan_prepare_shoot(plan.N, plan.p)
    models, runs = {}, {}
    for arch, cfg in cfgs:
        model = build_model(cfg)
        prompts = ssm_prompts(cfg.vocab_size)
        total = max(map(len, prompts)) + SERVE_MAX_NEW
        spec = (model.init_cache(FIXED_PROMPTS, SSM_MAX_LEN, device="meta"),
                {"tokens": meta((FIXED_PROMPTS, total), torch.int32), "pos": meta((), torch.int32)})
        S = -(-limb_count(spec) // SERVE_K)
        entry = f"{arch}: CodedServeGuard.snapshot"
        models[arch] = {"arch": arch, "model": model, "prompts": prompts, "total": total, "spec": spec, "S": S,
                        "entry": entry}
        runs[entry] = in_blocks(lambda w: [("gf_matmul", (plan.N, lps.n, lps.m, w))], S, plan.N)
    return {"name": name, "q": NTT, "K": SERVE_K, "plan": plan, "models": models, "runs": runs}


def ssm_config() -> dict:
    """Phase 12's configuration: RWKV6-3B cut to RWKV_LAYERS, Jamba to
    JAMBA_LAYERS."""
    return refeed_config("ssm", ((RWKV_ARCH, get(RWKV_ARCH).replace(n_layers=RWKV_LAYERS)),
                                 (JAMBA_ARCH, get(JAMBA_ARCH).replace(n_layers=JAMBA_LAYERS))))


def launcher(arch: str, prompts, *extra: str) -> tuple:
    """``launch/serve.py``'s ``main`` over ``prompts`` on the card (its
    weights: seed 0) with the flags ``extra``, its printed lines kept aside.
    Returns (result, the lines it printed); the engine's numbers are on the
    global registry."""
    argv = ["--arch", arch, *extra, "--prompts", ";".join(",".join(map(str, p)) for p in prompts),
            "--max-new", str(SERVE_MAX_NEW), "--max-len", str(SSM_MAX_LEN)]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = serve_main(argv)
    return res, out.getvalue().splitlines()


def refeed(step, params, cache, toks, plen, start: int, stop: int, vocab: int):
    """Ticks ``start`` .. ``stop - 1`` of the fixed engine's greedy refeed
    (``Engine.generate``'s loop): token t of every row in at position t, the
    argmax written at t + 1 past each row's prompt (``toks`` in place); on a
    mesh the logits are gathered whole first, as the engine gathers them."""
    B = toks.shape[0]
    for t in range(start, stop):
        lg, cache = step(params, cache, toks[:, t: t + 1], torch.full((B,), t, dtype=torch.int32, device=toks.device))
        nxt = torch.argmax(whole(lg)[:, 0, :vocab], dim=-1).to(torch.int32)
        toks[:, t + 1] = torch.where((t + 1) >= plen, nxt, toks[:, t + 1])
    return cache


def ssm_guard(scfg: dict, arch: str, params, dev, want: np.ndarray, what: str = "ssm") -> dict:
    """(b): the fixed engine's refeed driven tick by tick through
    ``make_decode_step``; at SSM_SNAPSHOT_TICK, mid-prompt, the recurrent
    cache and ``{"tokens", "pos"}`` under ``CodedServeGuard(K=6, R=2)``;
    SSM_LOST_TICKS more ticks, then host SSM_KILL_HOST dies: ``poll`` and
    ``recover``. The recovered state equals the snapshotted bytes, and the
    refeed resumed from it until the shortest prompt's request is complete
    gives ``want``, (a)'s tokens, in every column written by then."""
    m = scfg["models"][arch]
    model, prompts, total = m["model"], m["prompts"], m["total"]
    V = model.cfg.vocab_size
    toks_np = np.zeros((len(prompts), total), np.int32)
    for b, p in enumerate(prompts):
        toks_np[b, : len(p)] = p
    toks = torch.from_numpy(toks_np).to(dev)
    plen = torch.tensor([len(p) for p in prompts], device=dev)
    step = make_decode_step(model)
    T = SSM_SNAPSHOT_TICK
    cache = refeed(step, params, model.init_cache(len(prompts), SSM_MAX_LEN, device=dev), toks, plen, 0, T, V)
    state = {"tokens": toks, "pos": torch.tensor(T, dtype=torch.int32, device=dev)}
    held = tree.map(torch.clone, (cache, state))
    guard = CodedServeGuard(K=SERVE_K, R=SERVE_R, injector=FaultInjector(kills=((T, SSM_KILL_HOST),)), device=dev)
    before = launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    guard.snapshot(cache, state, tick=T)
    torch.cuda.synchronize()
    snap_ms = (time.perf_counter() - t0) * 1e3
    counted = check_launches(what, m["entry"], before, scfg["runs"][m["entry"]])
    check(all(len(v) == m["S"] for v in guard.group._mem.values()),
          f"{what}/{arch}: the coded shards are not {m['S']} limbs wide (the width phase 3 held)")
    cache = refeed(step, params, cache, toks, plen, T, T + SSM_LOST_TICKS, V)  # progress the fault loses
    dead = guard.poll(T + SSM_LOST_TICKS)
    check(dead == [SSM_KILL_HOST], f"{what}/{arch}: the guard found hosts {dead} dead")
    host_ms: list = []
    with timed(serve_coded, "lcc_decode", host_ms):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back = guard.recover(dead)
        torch.cuda.synchronize()
        rec_ms = (time.perf_counter() - t0) * 1e3
    bit_exact = same_bits(back, held)
    check(bit_exact, f"{what}/{arch}: the recovered state differs from the snapshot's bytes")
    cache_b, state_b = back
    stop = min(map(len, prompts)) + SERVE_MAX_NEW - 1  # the shortest request's last token is written at tick stop - 1
    refeed(step, params, cache_b, state_b["tokens"], plen, int(state_b["pos"]), stop, V)
    resumed_equal = np.array_equal(state_b["tokens"][:, : stop + 1].cpu().numpy(), want[:, : stop + 1])
    check(resumed_equal, f"{what}/{arch}: the refeed resumed from the recovered state gives other tokens than (a)")
    return {"snapshot_tick": T, "lost_ticks": SSM_LOST_TICKS, "killed_host": SSM_KILL_HOST, "K": SERVE_K,
            "R": SERVE_R, "q": NTT, "state_bytes": spec_bytes(m["spec"]), "cache_bytes": spec_bytes(m["spec"][0]),
            "limbs_a_shard": m["S"], "gf_matmul_shape": scfg["runs"][m["entry"]][0][1], "launches": counted,
            "snapshot_ms": snap_ms, "recover_ms": rec_ms, "lcc_decode_host_numpy_ms": host_ms[0],
            "recovered_bit_exact": bit_exact, "resumed_to_tick": stop, "resumed_tokens_equal": resumed_equal}


def ssm_tick(model, params, dev, tick_bytes: int, what: str,
             counted: str = "every weight but embed read once a tick") -> dict:
    """One refeed tick of FIXED_PROMPTS rows at position SSM_MAX_LEN // 2
    (median of 10) against its bound (``tick_bytes`` read once, which
    ``counted`` names), and SSM_TICK_CHUNK ticks under the profiler:
    kernels a tick, idle share."""
    V = model.cfg.vocab_size
    B = FIXED_PROMPTS
    cache = model.init_cache(B, SSM_MAX_LEN, device=dev)
    step = make_decode_step(model)
    toks = torch.from_numpy(np.random.default_rng(SEED + 1301).integers(1, V, size=(B, 1)).astype(np.int32)).to(dev)
    pos = torch.full((B,), SSM_MAX_LEN // 2, dtype=torch.int32, device=dev)  # Jamba's attention reads half its rows
    tick = lambda: step(params, cache, toks, pos)  # noqa: E731
    tick()
    ms = wall_ms(tick, 10)

    def chunk():
        for _ in range(SSM_TICK_CHUNK):
            tick()

    prof = profile_encode(f"{what}/decode_chunk", chunk, 1, kind=train_kernel_kind)
    bound_ms = tick_bytes / HBM_BYTES_PER_S * 1e3
    return {"decode_tick_ms": ms, "decode_tick_bound": {"bytes": tick_bytes, "ms": bound_ms, "what": counted},
            "decode_tick_share_of_bound": bound_ms / ms,
            "kernels_a_tick": prof["device_kernels_launched"] / SSM_TICK_CHUNK, "decode_chunk_profile": prof}


def layer_scan_check(fwd, decode, layer, cfg, dev, seed: int, what: str) -> dict:
    """(c): one full-width layer, its bf16 weights taken to float32:
    ``fwd`` over SSM_SCAN_TOKENS tokens against SSM_SCAN_TOKENS calls of
    ``decode`` from zeros, outputs and final states within SSM_SCAN_REL_TOL
    of their largest value."""
    p = tree.map(lambda t: t.float(), layer)
    cfg = cfg.replace(dtype="float32")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randn((SSM_SCAN_ROWS, SSM_SCAN_TOKENS, cfg.d_model), generator=g, device=dev)
    t0 = time.perf_counter()
    y, state = fwd(p, x, cfg)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    ys, dstate = [], None
    t0 = time.perf_counter()
    for t in range(SSM_SCAN_TOKENS):
        yt, dstate = decode(p, x[:, t: t + 1], cfg, dstate)
        ys.append(yt)
    torch.cuda.synchronize()
    dec_ms = (time.perf_counter() - t0) * 1e3
    pairs = [("y", y, torch.cat(ys, dim=1))] + [(f"state_{i}", a, b) for i, (a, b) in
                                                 enumerate(zip(tree.leaves(state), tree.leaves(dstate)))]
    errs = {k: {"max_abs_err": float((a - b).abs().max()), "largest": float(b.abs().max())} for k, a, b in pairs}
    rec = {"tokens": SSM_SCAN_TOKENS, "rows": SSM_SCAN_ROWS, "dtype": "float32 (bf16 weights)",
           "rel_tolerance": SSM_SCAN_REL_TOL, "errors": errs, "full_sequence_ms": fwd_ms, "decode_calls_ms": dec_ms}
    check(all(bool(torch.isfinite(a).all()) for _, a, _ in pairs)
          and all(e["max_abs_err"] <= SSM_SCAN_REL_TOL * e["largest"] for e in errs.values()),
          f"{what}: the full-sequence scan differs from the decode steps: {rec}")
    return rec


def mamba_scan_check(layer, cfg, dev) -> dict:
    def fwd(p, x, c):
        return SSM.mamba_fwd(p, x, c, return_state=True)

    def decode(p, x, c, state):
        if state is None:
            state = SSM.mamba_state_init(c, x.shape[0], torch.float32, x.device)
        return SSM.mamba_decode(p, x, c, state)

    return layer_scan_check(fwd, decode, layer, cfg, dev, SEED + 1302, "ssm/mamba_scan")


def rwkv_scan_check(layer, cfg, dev) -> dict:
    def fwd(p, x, c):
        return SSM.rwkv6_time_mix(p, x, c, return_state=True)

    def decode(p, x, c, state):
        wkv, prev = (None, None) if state is None else state
        return SSM.rwkv6_time_mix(p, x, c, state=wkv, x_prev=prev, return_state=True)

    return layer_scan_check(fwd, decode, layer, cfg, dev, SEED + 1303, "ssm/wkv6_scan")


def rwkv_forward_vs_refeed(model, params, dev) -> dict:
    """(c): the whole model's bf16 ``forward`` over SSM_SCAN_TOKENS tokens
    against the same tokens refed through ``decode_step``: every logit
    within SSM_FORWARD_TOL (rtol = atol)."""
    V = model.cfg.vocab_size
    B, S = SSM_SCAN_ROWS, SSM_SCAN_TOKENS
    toks = torch.from_numpy(np.random.default_rng(SEED + 1304).integers(0, V, size=(B, S)).astype(np.int32)).to(dev)
    full = model.forward(params, {"tokens": toks})[0][..., :V]
    cache = model.init_cache(B, S, device=dev)
    step = make_decode_step(model)
    worst, big = 0.0, 0.0
    for t in range(S):
        lg, cache = step(params, cache, toks[:, t: t + 1], torch.full((B,), t, dtype=torch.int32, device=dev))
        a, b = lg[:, 0, :V], full[:, t]
        worst = max(worst, float(((a - b).abs() - SSM_FORWARD_TOL * b.abs()).max()))
        big = max(big, float(b.abs().max()))
    rec = {"tokens": S, "rows": B, "rtol": SSM_FORWARD_TOL, "atol": SSM_FORWARD_TOL,
           "max_excess_over_rtol": worst, "largest_logit": big}
    check(bool(torch.isfinite(full).all()) and worst <= SSM_FORWARD_TOL,
          f"ssm/rwkv: forward logits differ from the refeed's beyond rtol = atol = {SSM_FORWARD_TOL}: {rec}")
    return rec


def ssm_init(model, dev, seed: int, arch: str, what: str = "ssm", nbytes: int | None = None) -> tuple:
    """The model's bf16 weights drawn on the emptied card from ``seed``
    (float32 routers and SSM constants), ``nbytes`` of them (by default
    SSM_PARAM_BYTES[arch]); returns (params, record)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    check(held < MOE_HELD_MAX, f"{what}/{arch}: earlier phases still hold {held} bytes of the card")
    free_bytes, total_bytes = torch.cuda.mem_get_info()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    by = sum(t.numel() * t.element_size() for t in tree.leaves(params))
    check(all(t.is_cuda for t in tree.leaves(params))
          and all(t.dtype == (torch.float32 if k.endswith(("router", "A_log", "dt_proj_b", "/D", "w0", "/u"))
                              else torch.bfloat16) for k, t in tree.flatten_with_names(params).items()),
          f"{what}/{arch}: the weights are not bf16 (float32 routers and SSM constants) on the card")
    want = SSM_PARAM_BYTES[arch] if nbytes is None else nbytes
    check(by == want, f"{what}/{arch}: the weights hold {by} bytes, not {want}")
    return params, {"params": sum(t.numel() for t in tree.leaves(params)), "param_bytes": by, "held_bytes": held,
                    "free_bytes_at_start": free_bytes, "total_bytes": total_bytes,
                    "init_s": time.perf_counter() - t0, "init_peak_bytes": torch.cuda.max_memory_allocated()}


def ssm_phase(scfg: dict, dev) -> tuple[dict, dict]:
    """The SSM families at full width (``scfg`` from :func:`ssm_config`),
    counted on their own. RWKV6-3B at RWKV_LAYERS layers, then Jamba at
    JAMBA_LAYERS layers, each on the emptied card: (a) greedy through the
    fixed ``Engine``, twice, the same SHA-256; (b) the guard on the recurrent
    state mid-refeed, a kill, a bit-exact recovery and the same tokens
    resumed; (c) one real layer's full-sequence scan against its decode
    steps, and RWKV6's forward against its refeed; (d) the float32 smoke
    configs on the card against the CPU. Returns (launches, record)."""
    t_phase = time.perf_counter()
    record = {}
    gf_matmul_cuda.launches = 0
    butterfly_mac_rows_cuda.launches = 0

    # RWKV6-3B, RWKV_LAYERS of 32 layers: (a) through Engine
    m = scfg["models"][RWKV_ARCH]
    model, cfg = m["model"], m["model"].cfg
    check(cfg.n_layers == RWKV_LAYERS and cfg.d_model == 2560 and cfg.n_heads == 40 and cfg.d_ff == 8960
          and cfg.vocab_size == 65536 and model.body == ["rwkv"] and model.repeats == RWKV_LAYERS,
          "ssm: not RWKV6-3B's width")
    params, init = ssm_init(model, dev, 0, RWKV_ARCH)
    runs = []
    for _ in range(2):
        reg = MetricsRegistry()
        res = Engine(model, params, max_len=SSM_MAX_LEN, metrics=reg).generate(m["prompts"],
                                                                               max_new_tokens=SERVE_MAX_NEW)
        runs.append(fixed_record("ssm/rwkv/engine", res, m["prompts"], reg, cfg.vocab_size))
    check(launches() == (0, 0), "ssm: the unguarded RWKV6 serve launched a hand kernel")
    check(runs[0]["sha256"] == runs[1]["sha256"], "ssm/rwkv: two greedy runs gave other tokens")
    rec = {"arch": cfg.name, "layers": f"{cfg.n_layers} of {get(RWKV_ARCH).n_layers}",
           "prompt_lens": [len(p) for p in m["prompts"]], "max_len": SSM_MAX_LEN, "max_new": SERVE_MAX_NEW,
           "init": init, "greedy": runs}
    rec["guard"] = ssm_guard(scfg, RWKV_ARCH, params, dev, res.tokens)  # (b)
    rec["scan"] = rwkv_scan_check(tree.map(lambda t: t[0], params["body"]["b0"]["tm"]), cfg, dev)  # (c)
    rec["forward_vs_refeed"] = rwkv_forward_vs_refeed(model, params, dev)
    rec.update(ssm_tick(model, params, dev, rec["init"]["param_bytes"]
                        - params["embed"].numel() * params["embed"].element_size(), "ssm/rwkv"))
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    record["rwkv"] = rec
    del params
    gc.collect()

    # Jamba, JAMBA_LAYERS of 32 layers: (a) through Engine
    m = scfg["models"][JAMBA_ARCH]
    model, cfg = m["model"], m["model"].cfg
    sc, mc = cfg.ssm, cfg.moe
    check(cfg.d_model == 4096 and cfg.n_heads == 32 and cfg.n_kv_heads == 8 and cfg.d_ff == 14336
          and mc.n_experts == 16 and mc.top_k == 2 and mc.expert_ff == 14336 and sc.d_state == 16
          and sc.expand == 2 and cfg.vocab_size == 65536 and cfg.n_layers == JAMBA_LAYERS
          and model.repeats == JAMBA_LAYERS // 8
          and model.body == ["mamba", "mamba_moe", "mamba", "mamba_moe", "dense", "mamba_moe", "mamba", "mamba_moe"],
          "ssm: not Jamba's width and period")
    params, init = ssm_init(model, dev, SEED + 1300, JAMBA_ARCH)
    check(tuple(params["body"]["b1"]["moe"]["w_gate"].shape) == (model.repeats, 16, 4096, 14336)
          and tuple(params["body"]["b0"]["mamba"]["x_proj"].shape) == (model.repeats, 8192, 256 + 32),
          "ssm: Jamba's leaves")
    rec = {"arch": cfg.name, "layers": f"{cfg.n_layers} of {get(JAMBA_ARCH).n_layers} ({model.repeats} periods of 8)",
           "prompt_lens": [len(p) for p in m["prompts"]], "max_len": SSM_MAX_LEN, "max_new": SERVE_MAX_NEW,
           "init": init, "capacity": {"factor": mc.capacity_factor,
                                      "decode": model_layers.moe_capacity(FIXED_PROMPTS, cfg)}}
    runs = []
    before = launches()
    for i in range(2):
        reg = MetricsRegistry()
        choices: list = []
        with routed(choices) if i == 0 else contextlib.nullcontext():
            res = Engine(model, params, max_len=SSM_MAX_LEN, metrics=reg).generate(m["prompts"],
                                                                                   max_new_tokens=SERVE_MAX_NEW)
        runs.append(fixed_record("ssm/jamba/engine", res, m["prompts"], reg, cfg.vocab_size))
        if i == 0:
            moe_layers = model.repeats * sum(k.endswith("moe") for k in model.body)
            rec["capacity_drops"] = moe_drops(choices, cfg, layers=moe_layers, what="ssm/jamba")
            del choices
    check(launches() == before, "ssm: the unguarded Jamba serve launched a hand kernel")
    check(runs[0]["sha256"] == runs[1]["sha256"], "ssm/jamba: two greedy runs gave other tokens")
    rec["greedy"] = runs
    rec["guard"] = ssm_guard(scfg, JAMBA_ARCH, params, dev, res.tokens)  # (b)
    rec["scan"] = mamba_scan_check(tree.map(lambda t: t[0], params["body"]["b0"]["mamba"]), cfg, dev)  # (c)
    rec.update(ssm_tick(model, params, dev, init["param_bytes"]
                        - params["embed"].numel() * params["embed"].element_size(), "ssm/jamba"))
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    record["jamba"] = rec
    del params, res
    gc.collect()
    torch.cuda.empty_cache()

    counted = {"gf_matmul": gf_matmul_cuda.launches, "butterfly_mac": butterfly_mac_rows_cuda.launches}
    want = sum(count_calls(calls)[0] for calls in scfg["runs"].values())  # one snapshot a model, in column blocks
    check(counted["gf_matmul"] == want,
          f"the SSM serve path launched gf_matmul {counted['gf_matmul']} times, not {want}")
    record["launches"] = counted
    # (d): the float32 smoke configs on the card against the CPU
    record["small_vs_cpu"] = {arch: small_vs_cpu(smoke_config(arch).replace(dtype="float32"), dev, SEED + 1305 + i,
                                                 f"ssm/small_{arch}", steps=SSM_SMALL_STEPS)
                              for i, arch in enumerate((RWKV_ARCH, JAMBA_ARCH))}
    torch.cuda.empty_cache()
    record["seconds"] = time.perf_counter() - t_phase
    return counted, record

# ---------------------------------------------------------------------------
# phase 13: the encoder-decoder and VLM families, Whisper-base whole, InternVL2-26B at 6 of 48 layers
# ---------------------------------------------------------------------------

WHISPER_ARCH, VLM_ARCH = "whisper-base", "internvl2-26b"
# both at full width, bf16: the frontends are stubs (precomputed frame and
# patch embeddings), so InternVL2's weights are InternLM2-20B's. Whisper is
# whole; InternVL2 runs 6 of its 48 layers (for time: 24 once phase mesh was
# added, 12 once phase coded_mesh was, 6 once phase moe_mesh was; 39.7 GB whole)
VLM_LAYERS = 6
ENCVLM_PARAM_BYTES = {WHISPER_ARCH: 207_176_704, VLM_ARCH: 6_958_510_080}
ORACLE_TOL = 0.2  # (c): tests/test_attention_oracle.py:57-85, decode against forward, rtol = atol
ORACLE_ROWS, ORACLE_TOKENS = 2, 64
VLM_FORWARD_TEXT = 256  # (c): one forward of n_patches (256) patches and this many text tokens


def encvlm_config() -> dict:
    """Phase 13's configuration: Whisper-base whole and InternVL2-26B at
    VLM_LAYERS layers (the guard's state holds Whisper's ``enc_out``)."""
    return refeed_config("encdec_vlm", ((WHISPER_ARCH, get(WHISPER_ARCH)),
                                        (VLM_ARCH, get(VLM_ARCH).replace(n_layers=VLM_LAYERS))))


def encvlm_serve(m: dict, runs_n: int, what: str) -> dict:
    """(a): ``runs_n`` greedy serves of the prompts through the launcher's
    default engine, which must fall back to the fixed engine and say so;
    every run hashes alike. Returns the record, the last run's tokens under
    ``"want"``."""
    model, cfg = m["model"], m["model"].cfg
    runs, res = [], None
    before = launches()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(runs_n):
        del res
        res, lines = launcher(m["arch"], m["prompts"], "--layers", str(cfg.n_layers))  # the default engine
        check(lines[0] == f"{cfg.name}: no one-pass prefill; falling back to fixed-batch",
              f"{what}: the launcher did not fall back to the fixed engine: {lines[:2]}")
        runs.append(fixed_record(f"{what}/launcher", res, m["prompts"], get_registry(), cfg.vocab_size)
                    | {"printed": lines[:2]})
    check(launches() == before, f"{what}: the unguarded serve launched a hand kernel")
    check(len({r["sha256"] for r in runs}) == 1, f"{what}: two greedy runs gave other tokens")
    return {"arch": cfg.name, "layers": f"{cfg.n_layers} of {get(m['arch']).n_layers}",
            "prompt_lens": [len(p) for p in m["prompts"]], "max_len": SSM_MAX_LEN, "max_new": SERVE_MAX_NEW,
            "greedy": runs, "launcher_peak_bytes": torch.cuda.max_memory_allocated(), "want": res.tokens}


def decode_tick_bytes(model, params, positions=(SSM_MAX_LEN // 2,) * FIXED_PROMPTS) -> tuple[int, str]:
    """What one decode tick of a row at each of ``positions`` (by default
    FIXED_PROMPTS rows at SSM_MAX_LEN // 2) must read, and its description:
    every weight it uses once (all but ``embed`` and, for the
    encoder-decoder, the encoder's own layers and ``ln_post``), the K/V rows
    at positions 0 .. pos of every layer, and the encoder-decoder's
    ``enc_out`` once a cross layer. ``params`` may be meta tensors."""
    cfg = model.cfg
    unused = ("embed", "encoder/layers/", "encoder/ln_post/")
    w = sum(t.numel() * t.element_size() for k, t in tree.flatten_with_names(params).items()
            if not k.startswith(unused))
    el = torch.finfo(model.dtype).bits // 8
    kv = 2 * cfg.n_layers * sum(p + 1 for p in positions) * cfg.n_kv_heads * cfg.head_dim * el
    enc = cfg.n_layers * len(positions) * cfg.encdec.n_frames * cfg.d_model * el if model.is_encdec else 0
    return w + kv + enc, (f"weights {w} B (all but embed{' and the encoder' if enc else ''}) + K/V rows 0..pos {kv} B"
                          + (f" + enc_out a cross layer {enc} B" if enc else ""))


def whisper_oracle(model, params, dev) -> dict:
    """(c): the reference's own oracle at full width: ``forward`` over
    ``make_batch(cfg, 2, 64)`` (1,500 frames through the encoder), then 64
    ``decode_step``s over a cache whose ``enc_out`` is the frames' encoding:
    every decode logit within ORACLE_TOL (rtol = atol) of the forward's, and
    the cross-attention adds something (the first tick over a zero
    ``enc_out`` gives other logits)."""
    cfg = model.cfg
    V, B, S = cfg.vocab_size, ORACLE_ROWS, ORACLE_TOKENS
    batch = make_batch(cfg, B, S, seed=SEED + 1401, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc = model._encode_frames(params, batch["frames"].to(model.dtype))
    torch.cuda.synchronize()
    enc_ms = (time.perf_counter() - t0) * 1e3
    full = model.forward(params, batch)[0][..., :V]
    step = make_decode_step(model)
    bare = model.init_cache(B, S, device=dev)
    first_bare = step(params, bare, batch["tokens"][:, :1], torch.zeros((B,), dtype=torch.int32, device=dev))[0]
    cache = model.init_cache(B, S, device=dev)
    cache["enc_out"].copy_(enc)
    worst, big, moved = -float("inf"), 0.0, 0.0
    for t in range(S):
        lg, cache = step(params, cache, batch["tokens"][:, t: t + 1], torch.full((B,), t, dtype=torch.int32, device=dev))
        a, b = lg[:, 0, :V], full[:, t]
        worst = max(worst, float(((a - b).abs() - ORACLE_TOL * b.abs()).max()))
        big = max(big, float(b.abs().max()))
        if t == 0:
            moved = float((lg - first_bare)[:, 0, :V].abs().max())
    rec = {"rows": B, "tokens": S, "frames": cfg.encdec.n_frames, "rtol": ORACLE_TOL, "atol": ORACLE_TOL,
           "max_excess_over_rtol": worst, "largest_logit": big, "encode_frames_ms": enc_ms,
           "enc_out_rms": float(enc.float().pow(2).mean().sqrt()), "cross_attention_moves_logits_by": moved}
    check(bool(torch.isfinite(full).all()) and worst <= ORACLE_TOL,
          f"encdec/whisper: decode logits differ from forward's beyond rtol = atol = {ORACLE_TOL}: {rec}")
    check(moved > 0, f"encdec/whisper: cross-attention onto the encoder's output changes nothing: {rec}")
    return rec


def vlm_forward(model, params, dev) -> dict:
    """(c): one ``prefill`` (``forward``) at batch 1 over n_patches patches
    and VLM_FORWARD_TEXT text tokens at full width, twice: the logits'
    hashes equal, finite, of shape (1, VLM_FORWARD_TEXT, vocab_padded)."""
    cfg = model.cfg
    batch = make_batch(cfg, 1, cfg.vlm.n_patches + VLM_FORWARD_TEXT, seed=SEED + 1402, device=dev)
    hashes, ms = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = model.prefill(params, batch)[0]
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        host = logits.cpu().numpy()
        hashes.append(hashlib.sha256(host.tobytes()).hexdigest())
    rec = {"patches": cfg.vlm.n_patches, "text_tokens": VLM_FORWARD_TEXT, "shape": list(host.shape),
           "ms": ms, "sha256": hashes, "finite": bool(np.isfinite(host).all())}
    check(host.shape == (1, VLM_FORWARD_TEXT, cfg.vocab_padded) and rec["finite"] and hashes[0] == hashes[1],
          f"vlm/internvl2: the prefill's logits: {rec}")
    return rec


def encvlm_phase(ecfg: dict, dev) -> tuple[dict, dict]:
    """The encoder-decoder and VLM families whole at full width (``ecfg``
    from :func:`encvlm_config`), counted on their own, each on the emptied
    card: (a) greedy through ``launch/serve.py`` with its default engine,
    which falls back to the fixed engine (Whisper twice, InternVL2 once, one
    SHA-256); (b) the guard on the decode cache mid-refeed, a kill, a
    bit-exact recovery and the same tokens resumed; (c) Whisper's decode
    against its forward over encoded frames, InternVL2's prefill twice; (d)
    the float32 smoke configs on the card against the CPU. Returns
    (launches, record)."""
    t_phase = time.perf_counter()
    record = {}
    gf_matmul_cuda.launches = 0
    butterfly_mac_rows_cuda.launches = 0

    m = ecfg["models"][WHISPER_ARCH]
    model, cfg = m["model"], m["model"].cfg
    check(cfg.n_layers == 6 and cfg.encdec.n_enc_layers == 6 and cfg.d_model == 512 and cfg.n_heads == 8
          and cfg.d_ff == 2048 and cfg.encdec.n_frames == 1500 and cfg.vocab_padded == 51968
          and model.body == ["dense"] and model.repeats == 6 and model.is_encdec, "encdec: not Whisper-base's width")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    check(torch.cuda.memory_allocated() < MOE_HELD_MAX, "encdec: earlier phases still hold the card")
    rec = encvlm_serve(m, 2, "encdec/whisper")  # (a)
    want = rec.pop("want")
    params, rec["init"] = ssm_init(model, dev, 0, WHISPER_ARCH, "encdec", ENCVLM_PARAM_BYTES[WHISPER_ARCH])
    check(tuple(params["encoder"]["layers"]["mlp"]["w_up"].shape) == (6, 512, 2048)
          and tuple(params["encoder"]["cross"]["attn"]["wq"].shape) == (6, 512, 512), "encdec: Whisper's leaves")
    rec["guard"] = ssm_guard(ecfg, WHISPER_ARCH, params, dev, want, "encdec")  # (b)
    rec["oracle"] = whisper_oracle(model, params, dev)  # (c)
    tick_bytes, counted = decode_tick_bytes(model, params)
    rec.update(ssm_tick(model, params, dev, tick_bytes, "encdec/whisper", counted))
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    record["whisper"] = rec
    del params, want
    gc.collect()

    m = ecfg["models"][VLM_ARCH]
    model, cfg = m["model"], m["model"].cfg
    check(cfg.n_layers == VLM_LAYERS and cfg.d_model == 6144 and cfg.n_heads == 48 and cfg.n_kv_heads == 8
          and cfg.d_ff == 16384 and cfg.vocab_padded == 92672 and cfg.vlm.n_patches == 256
          and model.body == ["dense"] and model.repeats == VLM_LAYERS and model.is_vlm,
          "vlm: not InternVL2-26B's width")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    check(torch.cuda.memory_allocated() < MOE_HELD_MAX, "vlm: earlier phases still hold the card")
    rec = encvlm_serve(m, 1, "vlm/internvl2")  # (a)
    want = rec.pop("want")
    params, rec["init"] = ssm_init(model, dev, 0, VLM_ARCH, "vlm", ENCVLM_PARAM_BYTES[VLM_ARCH])
    rec["guard"] = ssm_guard(ecfg, VLM_ARCH, params, dev, want, "vlm")  # (b)
    rec["prefill"] = vlm_forward(model, params, dev)  # (c)
    tick_bytes, counted = decode_tick_bytes(model, params)
    rec.update(ssm_tick(model, params, dev, tick_bytes, "vlm/internvl2", counted))
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    record["internvl2"] = rec
    del params, want
    gc.collect()
    torch.cuda.empty_cache()

    counted = {"gf_matmul": gf_matmul_cuda.launches, "butterfly_mac": butterfly_mac_rows_cuda.launches}
    want = sum(count_calls(calls)[0] for calls in ecfg["runs"].values())  # one snapshot a model, in column blocks
    check(counted["gf_matmul"] == want,
          f"the encoder-decoder and VLM serve paths launched gf_matmul {counted['gf_matmul']} times, not {want}")
    record["launches"] = counted
    # (d): the float32 smoke configs on the card against the CPU
    record["small_vs_cpu"] = {arch: small_vs_cpu(smoke_config(arch).replace(dtype="float32"), dev, SEED + 1405 + i,
                                                 f"encdec_vlm/small_{arch}", steps=SSM_SMALL_STEPS)
                              for i, arch in enumerate((WHISPER_ARCH, VLM_ARCH))}
    torch.cuda.empty_cache()
    record["seconds"] = time.perf_counter() - t_phase
    return counted, record


# ---------------------------------------------------------------------------
# phase 14: the analysis layer, the examples and trace_encode on the card
# ---------------------------------------------------------------------------

EXAMPLES = ("quickstart", "coded_checkpoint_recovery", "serve_lm", "train_lm")
TRAIN_LM_ARGV = ["--steps", "2", "--fail-at", "1", "--coded-every", "1"]  # at the example's own sizes
TRACE_K, TRACE_LEVELS, TRACE_PAYLOAD = 8, (2, 2, 2), 1 << 14  # tools/trace_encode_torch.py's defaults
TRACE_CALLS = 3  # the warm-up, the traced call and the untraced one it is held against
TRAIN_PEAK_SLACK = 1.5  # the tracker's peak at most this over the measured peak of the step
DRYRUN_LIMIT_S = 60.0


def load_script(rel: str):
    """A script of the checkout (``examples/``, ``tools/``) as a module; its
    ``main`` does not run."""
    spec = importlib.util.spec_from_file_location(os.path.basename(rel)[:-3], os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def analysis_configs() -> list[dict]:
    """The kernel calls of the examples and of ``trace_encode_torch`` (host
    side), for phase 3 (``path_shapes``) and the launch checks."""
    K = 16
    qplan = plan_for("general", K, 1, M31)
    dplan = plan_for("dft", K, 1, NTT)
    state = {"params": meta((1_000_000,), torch.float32), "m": meta((1_000_000,), torch.float32),
             "v": meta((1_000_000,), torch.float32), "step": meta((), torch.int32)}
    pplan = build_parity_plan(K)
    S_ck = -(-limb_count(state) // K)
    lm = build_model(load_script("examples/train_lm_torch.py").model_config())
    lm_spec = {"params": lm.param_specs(), "opt": state_specs(OptConfig(), lm.param_specs())}
    gplan = build_parity_plan(8)
    S_lm = -(-limb_count(lm_spec) // 8)
    f = Field(M31)
    ir = plan_multilevel(TRACE_K, 1, TRACE_LEVELS).to_ir(np.asarray(vandermonde(f, distinct_points(f, TRACE_K, seed=0))))
    return [
        {"name": "quickstart", "q": M31, "runs": {
            "a2a_encode": a2a_kernel_calls({"kind": "general", "plan": qplan, "K": K}, 1)}},
        {"name": "quickstart_dft", "q": NTT, "runs": {
            "a2a_encode": a2a_kernel_calls({"kind": "dft", "plan": dplan, "K": K}, 1)}},
        {"name": "coded_checkpoint_recovery", "q": M31, "S": S_ck, "runs": {
            "encode_parity": in_blocks(lambda w: [("gf_matmul", (K, pplan.ps_plan.n, pplan.ps_plan.m, w))], S_ck, K)}},
        {"name": "train_lm", "q": M31, "S": S_lm, "runs": {
            "CodedStateGuard.snapshot": in_blocks(
                lambda w: [("gf_matmul", (8, gplan.ps_plan.n, gplan.ps_plan.m, w))], S_lm, 8) * 2}},
        {"name": "trace_encode", "q": M31, "ir": ir, "runs": {
            "ir_encode": ir_kernel_calls(ir, TRACE_PAYLOAD) * TRACE_CALLS}},
    ]


def run_examples(acfgs: list[dict], dev) -> dict:
    """(a): the examples in this process on the card, each held to its own
    asserts and its launches to the calls phase 3 held."""
    runs = {c["name"]: c["runs"] for c in acfgs}
    out = {}
    for name in EXAMPLES:
        mod = load_script(f"examples/{name}_torch.py")
        argv = ["--device", str(dev)]
        if name == "train_lm":
            d = tempfile.mkdtemp(prefix="train_lm_ckpt")
            argv += TRAIN_LM_ARGV + ["--ckpt", d]
        before = launches()
        t0 = time.perf_counter()
        res = mod.main(argv)
        torch.cuda.synchronize()
        rec = {"argv": argv, "seconds": time.perf_counter() - t0}
        calls = {"quickstart": runs["quickstart"]["a2a_encode"] + runs["quickstart_dft"]["a2a_encode"],
                 "coded_checkpoint_recovery": runs["coded_checkpoint_recovery"]["encode_parity"],
                 "train_lm": runs["train_lm"]["CodedStateGuard.snapshot"]}.get(name, [])
        rec["launches"] = check_launches(name, "main", before, calls)
        if name == "quickstart":
            for form, (o, report) in res.items():
                check(o.is_cuda, f"quickstart: the {form} encode did not run on the card")
            rec["c1_c2"] = {form: [report.c1, report.c2] for form, (o, report) in res.items()}
        elif name == "coded_checkpoint_recovery":
            check(all(res["recovered"].values()), "coded_checkpoint_recovery: a recovery was not bit-exact")
            rec["recovered"] = res["recovered"]
            rec["shards"] = res["shards"]
            check(res["shards"][1] == next(c for c in acfgs if c["name"] == name)["S"],
                  "coded_checkpoint_recovery: the shard width is not the one phase 3 held")
        elif name == "serve_lm":
            rep = res["continuous"]
            check(len(rep.results) == 8 and res["sampled_differs"], "serve_lm: the demo did not serve its trace")
            rec.update(tokens_per_s=rep.tokens_per_s, ttft_ms=rep.ttft_ms, fixed_steps=int(res["fixed"].steps))
        else:
            check(res["recovered_exact"] is True, "train_lm: the recovery was not bit-exact")
            check(len(res["losses"]) == 2 and all(np.isfinite(res["losses"])), f"train_lm: losses {res['losses']}")
            rec.update(losses=res["losses"], params=res["params"], recovered_bit_exact=True)
            shutil.rmtree(d, ignore_errors=True)
        out[name] = rec
        torch.cuda.empty_cache()
    return out


def run_trace_encode(acfg: dict, dev) -> dict:
    """(b): tools/trace_encode_torch.py on the card at its default payload;
    its three files, the first two through the unchanged tools/check_trace.py."""
    tool = load_script("tools/trace_encode_torch.py")
    get_registry().reset()
    with tempfile.TemporaryDirectory() as d:
        prefix = os.path.join(d, "encode_torch")
        before = launches()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = tool.main(["--out", prefix, "--device", str(dev), "--drift"])
        text = buf.getvalue()
        check(rc == 0, f"trace_encode: exit {rc}")
        counted = check_launches("trace_encode", "main", before, acfg["runs"]["ir_encode"])
        ir = acfg["ir"]
        check(f"traced {ir.c1} comm rounds" in text, f"trace_encode: {text.splitlines()[:1]}")
        checks = {}
        for suffix in (".trace.json", ".jsonl"):
            r = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "check_trace.py"), prefix + suffix],
                               capture_output=True, text=True, timeout=120)
            check(r.returncode == 0, f"check_trace {suffix}: {r.stdout}{r.stderr}")
            checks[suffix] = r.stdout.strip()
        with open(prefix + ".metrics.json") as fh:
            metrics = json.load(fh)
        check(metrics["encode.rounds"]["value"] == 2 * ir.c1, f"trace_encode: encode.rounds {metrics['encode.rounds']}")
        spans = [json.loads(line) for line in open(prefix + ".jsonl")]
    return {"K": TRACE_K, "levels": TRACE_LEVELS, "payload_elems": TRACE_PAYLOAD, "c1": ir.c1, "launches": counted,
            "check_trace": checks, "encode.rounds": metrics["encode.rounds"]["value"],
            "rounds": [{k: s["attrs"].get(k) for k in ("comm_round", "level", "predicted_us")} | {"measured_us": s["dur_us"]}
                       for s in spans if "comm_round" in s.get("attrs", {})]}


def roofline_shares(served: dict, trained: dict, scfg: dict, card: str) -> dict:
    """(c): the op-level count of the train step and the decode tick that
    phases 7 and 8 timed, on meta tensors at the same shapes (nothing is
    rerun), against the card's data-sheet peaks (``card``: its name and
    power limit)."""
    tw = trained["full_width"]
    model = build_model(get(TRAIN_ARCH))
    batch, seq = tw["batch"], tw["seq"]
    step = make_train_step(model, OptConfig())
    pspec = model.param_specs()
    t0 = time.perf_counter()
    counter = count_fn(step, pspec, state_specs(OptConfig(), pspec),
                       train_batch_specs(model.cfg, ShapeSpec("train", "train", seq, batch)))
    count_s = time.perf_counter() - t0
    step_s = tw["median_step_ms_2_to_6"] / 1e3
    mf = model_flops(model.cfg, ShapeSpec("train", "train", seq, batch))
    state_bytes = sum(tw["state_bytes"].values())
    peak = counter.memory["peak_bytes"]
    check(state_bytes <= peak <= TRAIN_PEAK_SLACK * tw["peak_bytes"],
          f"analysis: the train step's tracker peak {peak} is not between the state's {state_bytes} B and "
          f"{TRAIN_PEAK_SLACK} x the measured peak {tw['peak_bytes']} B")
    train = {"arch": model.cfg.name, "batch": batch, "seq": seq, "remat": model.cfg.remat, "card": card,
             "median_step_ms": step_s * 1e3, "op_cost_flops": counter.cost.flops,
             "op_cost_product_flops": counter.cost.product_flops, "model_flops": mf,
             "mfu_op_cost": counter.cost.flops / (step_s * PEAK_FLOPS),
             "mfu_model_flops": mf / (step_s * PEAK_FLOPS), "peak_flops": PEAK_FLOPS,
             "tracker_peak_bytes": peak, "measured_peak_bytes": tw["peak_bytes"], "state_bytes": state_bytes,
             "count_s": count_s}
    smodel = scfg["model"]
    eng = serve_engine(smodel, smodel.param_specs())
    tick = eng._tick_for(True)
    trace = poisson_trace(SERVE_REQUESTS, SERVE_RATE, mix=SERVE_MIX, max_new_tokens=SERVE_MAX_NEW,
                          vocab_size=smodel.cfg.vocab_size, seed=SEED + 1001)
    positions = [len(trace[s].prompt) for s in range(SERVE_SLOTS)]  # serve_timings' slots as its ticks start
    counter = count_fn(lambda p, c, st: tick(p, c, st, -1, 1.0), smodel.param_specs(),
                       smodel.init_cache(SERVE_SLOTS, SERVE_POSITIONS, device="meta"), eng.init_state())
    tick_s = served["decode_tick_ms"] / 1e3
    least = decode_tick_bytes(smodel, smodel.param_specs(), positions)[0]
    check(counter.cost.bytes >= least,
          f"analysis: op_cost counts {counter.cost.bytes} B for the tick, under the {least} B it must read")
    decode = {"arch": smodel.cfg.name, "slots": SERVE_SLOTS, "max_len": SERVE_POSITIONS, "positions": positions,
              "card": card, "tick_ms": tick_s * 1e3, "op_cost_bytes": counter.cost.bytes,
              "op_cost_flash_bytes": counter.cost.bytes_flash, "least_bytes": least,
              "op_cost_over_least": counter.cost.bytes / least,
              "hbm_share_op_cost": counter.cost.bytes / (tick_s * HBM_BW),
              "hbm_share_least": least / (tick_s * HBM_BW), "hbm_bw": HBM_BW,
              "op_cost_flops": counter.cost.flops}
    return {"train_step": train, "decode_tick": decode}


def dry_run_all() -> dict:
    """(d): the one-card dry run of every (arch × shape) cell on meta
    tensors, in worker processes, and its roofline table."""
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        recs = dryrun.run_all(d, force=True, jobs=os.cpu_count() or 1)
        wall = time.perf_counter() - t0
        rows = roofline_load_all(d)
    print(render_table(rows), flush=True)
    check(len(recs) == 40, f"dry run: {len(recs)} records")
    for r in recs:
        ok, reason = shape_applicable(get(r["arch"]), ARCH_SHAPES[r["shape"]])
        check(r["status"] == ("ok" if ok else "skipped") and (ok or r["reason"] == reason),
              f"dry run: {r['arch']} x {r['shape']} is {r['status']}: {r.get('error', r.get('reason'))}")
    check(wall <= DRYRUN_LIMIT_S, f"dry run: {wall:.1f} s, over {DRYRUN_LIMIT_S} s")
    return {"seconds": wall, "jobs": os.cpu_count(), "ok": sum(r["status"] == "ok" for r in recs),
            "skipped": sum(r["status"] == "skipped" for r in recs),
            "fits_80GB": sorted(f"{r['arch']}/{r['shape']}" for r in recs if r.get("fits")),
            "rows": [{k: getattr(row, k) for k in ("arch", "shape", "status", "compute_s", "memory_s", "bottleneck",
                                                   "useful_ratio", "hbm_gb_per_dev")} for row in rows
                     if row.status == "ok"]}


def analysis_phase(acfgs: list[dict], dev, served: dict, trained: dict, scfg: dict, card: str) -> tuple[dict, dict]:
    """The examples and trace_encode on the card, counted on their own, then
    the roofline shares of phases 7 and 8's steps and the dry run. Returns
    (launches, record)."""
    t_phase = time.perf_counter()
    gf_matmul_cuda.launches = 0
    butterfly_mac_rows_cuda.launches = 0
    record = {"examples": run_examples(acfgs, dev)}  # (a)
    record["trace_encode"] = run_trace_encode(next(c for c in acfgs if c["name"] == "trace_encode"), dev)  # (b)
    counted = {"gf_matmul": gf_matmul_cuda.launches, "butterfly_mac": butterfly_mac_rows_cuda.launches}
    check(counted["gf_matmul"] > 0 and counted["butterfly_mac"] > 0,
          f"the examples and trace_encode launched {counted}")
    record["launches"] = counted
    record["roofline"] = roofline_shares(served, trained, scfg, card)  # (c)
    record["dryrun"] = dry_run_all()  # (d)
    record["seconds"] = time.perf_counter() - t_phase
    return counted, record


# ---------------------------------------------------------------------------
# phase 15: the sharding substrate on a (data=2, model=2) mesh of four ranks
# ---------------------------------------------------------------------------

MESH_SHAPE, MESH_AXES = (2, 2), ("data", "model")
MESH_REQUESTS, MESH_MAX_NEW = 6, 16  # the serve trace's first requests, each with this budget
# (b): the launcher's two prompts, served by (a)'s engine too, after the trace
MESH_PROMPTS = ((3, 14, 15, 92, 65, 35), (89, 79, 32, 38, 46, 26, 43, 38, 32, 79))
MESH_LAUNCHER_NEW = 4  # (b)'s budget: its tokens are the first of (a)'s for the same prompts
MESH_BUCKETS = (32, 64, 128, 256, 512)  # the launcher's buckets (scheduler.DEFAULT_BUCKETS) and 512
MESH_TRAIN_LAYERS, MESH_TRAIN_STEPS = 1, 2  # (c): launch/train.py at full width, 1 of 28 layers
# Phases 15 and 16 serve Qwen3-1.7B at every width, cut from 28 to 7 layers
# (whole before phase 17) to keep the script's time with phase 17: the whole
# script took 1,088 s on one host with the 28 layers and 1,212 s on a slower
# one with 14, and a tick, a snapshot and a host decode of the mesh phases
# go with the layer count
MESH_LAYERS = 7
PIPE_MICRO, PIPE_MB = 6, (2, 256, 2048)  # (d): microbatches of one Qwen3-1.7B block's input
# (d): the pipeline applies the same kernels to the same microbatches as the
# blocks in sequence on one rank; held within one bf16 ulp of the largest output
PIPE_TOL = 2.0 ** -7
# (a): the full-width logits of one prefill and one tick over the vocabulary,
# mesh against one process: bf16 sums in another order (partial products over
# the model axis, split-KV), held as phase 7 holds bf16 prefill against
# refeed: the rms error within REFEED_RMS_TOL of the rms, the largest error
# within REFEED_MAX_TOL of the largest logit
MESH_TIMEOUT_S = 300  # a rank's wait for its peers (the group's timeout)
MESH_DEADLINE_S = 600  # the whole phase: a rank that has not answered by then fails the run
MESH_PHASE_S = 150  # what the phase may take
MESH_DRY_CELL = ("qwen3-1.7b", "decode_32k")  # (e): the production-mesh cell the phase dry-runs


def mesh_config() -> dict:
    """Phase ``mesh``'s configuration, handed to every rank: the served
    model (Qwen3-1.7B, MESH_LAYERS layers), the pipeline's block config, max_len and the
    prefill buckets of (a), the serve trace's prompt mix, the pipeline's microbatch and the launchers'
    extra flags."""
    return {"serve": get(SERVE_ARCH).replace(n_layers=MESH_LAYERS), "pipe": get(TRAIN_ARCH), "max_len": SERVE_POSITIONS,
            "buckets": MESH_BUCKETS,
            "mix": SERVE_MIX, "pipe_mb": PIPE_MB, "launcher_extra": []}


def mesh_requests(mcfg: dict) -> list:
    """The serve trace's first MESH_REQUESTS requests, each with budget
    MESH_MAX_NEW, then (b)'s prompts (ids ``cli-i``, the launcher's), which
    arrive after them."""
    trace = poisson_trace(SERVE_REQUESTS, SERVE_RATE, mix=mcfg["mix"], max_new_tokens=SERVE_MAX_NEW,
                          vocab_size=mcfg["serve"].vocab_size, seed=SEED + 1001)[:MESH_REQUESTS]
    late = trace[-1].arrival_s + 1e-3
    return ([dataclasses.replace(r, max_new_tokens=MESH_MAX_NEW) for r in trace]
            + [Request(id=f"cli-{i}", prompt=list(p), max_new_tokens=MESH_MAX_NEW, arrival_s=late)
               for i, p in enumerate(MESH_PROMPTS)])


def mesh_small_requests() -> list:
    """The reference's staggered trace (tests/test_serve.py:298-332)."""
    prompts = [[5, 9, 2, 7, 1], [3, 3, 8], [11, 4, 6, 2, 9, 10, 1], [2], [7, 5, 5, 5, 1, 2]]
    return [Request(id=f"r{i}", prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]


def mesh_rules(cfg, max_len: int):
    """(a)'s rules: the reference's decode preset under its ``opt`` profile,
    which keeps a model of at most 8B parameters off FSDP (``d_model``
    whole): the launcher's with ``--profile opt``."""
    return rules_for(cfg, ShapeSpec("mesh", "decode", max_len, SERVE_SLOTS), OPT)


def mesh_engine(model, params, mcfg: dict, mesh=None, rules=None):
    """(a)'s engine; traced, so that its decode chunks are timed."""
    return ContinuousEngine(model, params, n_slots=SERVE_SLOTS, max_len=mcfg["max_len"], buckets=mcfg["buckets"],
                            max_new_tokens=MESH_MAX_NEW, mesh=mesh, rules=rules, metrics=MetricsRegistry(),
                            tracer=Tracer())


def logits_probe(model, params, req, max_len: int, buckets, mesh, rules, step_token: int | None = None) -> dict:
    """One prefill of ``req`` into slot 0 and one tick of all slots: both
    logits, whole (float32 numpy). The tick feeds slot 0 the prefill's
    argmax, or ``step_token`` where it is given (two runs whose argmax may
    part on a near-tie then tick on the same input)."""
    from repro_torch.serve.engine import _init_cache

    cache = _init_cache(model, SERVE_SLOTS, max_len, tree.leaves(params)[0].device, mesh, rules)
    pf = make_prefill_step(model, into_cache=True, rules=rules, mesh=mesh)
    dec = make_decode_step(model, rules, mesh=mesh)
    dev = tree.leaves(params)[0].device
    bucket = bucket_for(len(req.prompt), buckets)
    toks = torch.zeros((1, bucket), dtype=torch.int32)
    toks[0, :len(req.prompt)] = torch.tensor(req.prompt, dtype=torch.int32)
    last, cache = pf(params, cache, toks.to(dev), 0, len(req.prompt))
    last = whole(last)
    tok = torch.argmax(last[:, :model.cfg.vocab_size], dim=-1).to(torch.int32)
    step_toks = torch.zeros((SERVE_SLOTS, 1), dtype=torch.int32, device=dev)
    step_toks[0, 0] = tok[0] if step_token is None else step_token
    pos = torch.zeros((SERVE_SLOTS,), dtype=torch.int32, device=dev)
    pos[0] = len(req.prompt)
    lg, cache = dec(params, cache, step_toks, pos)
    V = model.cfg.vocab_size
    return {"prefill": last[0, :V].float().cpu().numpy(), "tick": whole(lg)[0, 0, :V].float().cpu().numpy(),
            "cache": cache, "step": (dec, step_toks, pos)}


def whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def logits_err(got: np.ndarray, want: np.ndarray) -> dict:
    """Logits ``got`` against ``want``: the rms of the error over the rms of
    ``want``, the largest error over the largest of ``want``, whether the
    argmaxes agree, whether ``got`` is finite."""
    return {"rms_of_rms": float(np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want ** 2))),
            "max_of_max": float(np.abs(got - want).max() / np.abs(want).max()),
            "argmax_equal": bool((got.argmax(-1) == want.argmax(-1)).all()), "finite": bool(np.isfinite(got).all())}


def local_bytes(params) -> int:
    return sum((t.to_local() if isinstance(t, DTensor) else t).numel() * t.element_size()
               for t in tree.leaves(params))


def mesh_serve(rank: int, dev, mcfg: dict) -> dict:
    """(a) on a rank: Qwen3-1.7B at MESH_LAYERS layers, the full weights drawn from the seed
    and each rank's shard kept; the engine over the trace and (b)'s prompts,
    its decode chunks timed; one prefill's and one tick's logits, and the
    collectives and staged bytes of a tick; the float32 smoke config over
    the reference's staggered trace."""
    from torch.distributed.tensor.debug import CommDebugMode

    mesh = make_mesh(MESH_SHAPE, MESH_AXES, device=dev)
    cfg, max_len = mcfg["serve"], mcfg["max_len"]
    model = build_model(cfg)
    rules = mesh_rules(cfg, max_len)
    sync(dev)
    reset_peak(dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    eng = mesh_engine(model, params, mcfg, mesh, rules)
    del params
    sync(dev)
    init_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    held = local_bytes(eng.params)
    rep = eng.serve(mesh_requests(mcfg), greedy=True, sync_every=SERVE_SYNC)
    hist = eng._registry().snapshot()
    probe = logits_probe(model, eng.params, mesh_requests(mcfg)[0], max_len, mcfg["buckets"], mesh, rules)
    dec, step_toks, pos = probe.pop("step")
    cache = probe.pop("cache")
    staging.reset_counts()
    sync(dev)
    t = time.perf_counter()
    with CommDebugMode() as cdm:
        dec(eng.params, cache, step_toks, pos)
    sync(dev)
    counted_tick_ms = (time.perf_counter() - t) * 1e3
    comm = {str(k): int(v) for k, v in cdm.get_comm_counts().items()}
    staged = {"bytes": staging.staged_bytes(), "calls": staging.staged_calls()}
    del cache
    out = {"tokens": tokens_of(rep), "tokens_per_s": rep.tokens_per_s, "decode_steps": rep.decode_steps,
           "wall_s": rep.wall_s, "ttft_ms": rep.ttft_ms,
           "tick_ms": hist["serve.decode_chunk_us"]["p50"] / SERVE_SYNC / 1e3,
           "prefill_ms": {"p50": hist["serve.prefill_us"]["p50"] / 1e3, "max": hist["serve.prefill_us"]["max"] / 1e3},
           "counted_tick_ms": counted_tick_ms, "tick_collectives": comm, "tick_staged": staged, "init_s": init_s,
           "held_bytes": held, "peak_bytes": peak(dev),
           "param_placements": {k: str(tuple(v.placements)) for k, v in
                                tree.flatten_with_names(eng.params["body"]["b0"]).items()}}
    if rank == 0:
        out["probe"] = probe
    del eng
    small = build_model(smoke_config(SERVE_ARCH).replace(dtype="float32", n_layers=2))
    sp = small.init(torch.Generator().manual_seed(SEED + 1300))
    seng = ContinuousEngine(small, sp, n_slots=4, max_len=32, buckets=(8, 16), max_new_tokens=8, mesh=mesh,
                            rules=rules_for(small.cfg, ShapeSpec("serve-test", "decode", 32, 4), BASELINE),
                            metrics=MetricsRegistry())
    out["small_tokens"] = tokens_of(seng.serve(mesh_small_requests(), greedy=True, sync_every=2))
    return out


def mesh_launcher(dev, mcfg: dict) -> dict:
    """(b) on a rank: ``launch/serve.py --mesh 2x2`` over MESH_PROMPTS in
    this world (rank 0 prints)."""
    argv = ["--arch", SERVE_ARCH, "--layers", str(MESH_LAYERS), "--mesh", "2x2", "--max-new", str(MESH_LAUNCHER_NEW),
            "--max-len", str(mcfg["max_len"]), "--profile", "opt",
            "--prompts", ";".join(",".join(map(str, p)) for p in MESH_PROMPTS), *mcfg["launcher_extra"]]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rep = serve_main(argv)
    return {"tokens": tokens_of(rep), "printed": out.getvalue().splitlines()}


def mesh_train_small(rank: int, dev) -> dict:
    """(c) on a rank: the float32 smoke config, SMALL_TRAIN_STEPS steps of
    ``make_train_step(mesh=)`` from train_small_vs_cpu's parameters and
    batches; rank 0 returns the whole state."""
    mesh = make_mesh(MESH_SHAPE, MESH_AXES, device=dev)
    model = build_model(smoke_config(TRAIN_ARCH).replace(dtype="float32"))
    rules = rules_for(model.cfg, ShapeSpec("mesh", "train", SMALL_TRAIN_SEQ, SMALL_TRAIN_BATCH), BASELINE)
    p = model.init(torch.Generator().manual_seed(SEED + 1100))
    st = init_state(RESUME_OPT, p)
    p, st = place((p, st), (param_shardings(model, mesh, rules), opt_state_shardings(RESUME_OPT, model, mesh, rules)))
    bsh = batch_shardings(model, mesh, rules)
    step = make_train_step(model, RESUME_OPT, rules=rules, mesh=mesh)
    ds = SyntheticLM(model.cfg)
    losses, lrs = [], []
    for s in range(SMALL_TRAIN_STEPS):
        b = ds.batch(s, SMALL_TRAIN_BATCH, SMALL_TRAIN_SEQ)
        p, st, m = step(p, st, place(to_device(b, dev), {k: bsh[k] for k in b}))
        losses.append(float(whole(m["loss"])))
        lrs.append(float(whole(m["lr"])))
    on_mesh = all(isinstance(t, DTensor) and t.device.type == dev.type for t in tree.leaves((p, st["m"], st["v"])))
    full = tree.map(lambda t: whole(t).cpu(), (p, st))
    return {"losses": losses, "lrs": lrs, "on_mesh": on_mesh, **({"state": full} if rank == 0 else {})}


def mesh_train_full(rank: int, dev, ckpt: str, mcfg: dict) -> dict:
    """(c) on a rank: ``launch/train.py --mesh 2x2`` at full width, cut to
    MESH_TRAIN_LAYERS layers, MESH_TRAIN_STEPS steps of 8 x 256, its
    checkpoint in ``ckpt``; then the checkpoint restored under the same
    shardings and the parameters resharded onto a 4 x 1 mesh, each rank's
    blocks held bit for bit against the file."""
    from repro_torch.train.checkpoint import _to_torch

    reset_peak(dev)
    argv = ["--arch", TRAIN_ARCH, "--mesh", "2x2", "--layers", str(MESH_TRAIN_LAYERS), "--steps",
            str(MESH_TRAIN_STEPS), "--batch", "8", "--seq", "256", "--coded-every", "0", "--ckpt", ckpt,
            *mcfg["launcher_extra"]]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run = train_main(argv)
    sync(dev)
    rec = {"history": run["history"], "seconds": run["seconds"], "peak_bytes": peak(dev),
           "held_bytes": local_bytes(run["state"])}
    model, rules, state = run["model"], run["rules"], run["state"]
    mesh = make_mesh(MESH_SHAPE, MESH_AXES, device=dev)
    like = {"params": model.param_specs(), "opt": state_specs(run["opt_cfg"], model.param_specs())}
    shardings = {"params": param_shardings(model, mesh, rules), "opt": opt_state_shardings(run["opt_cfg"], model,
                                                                                          mesh, rules)}
    t0 = time.perf_counter()
    restored, step = restore_checkpoint(ckpt, like, shardings=shardings)
    rec["restore_s"] = time.perf_counter() - t0
    rec["restored_step"] = step
    rec["restored_equal"] = all(tuple(a.placements) == tuple(b.placements) and same(a.to_local(), b.to_local())
                                for a, b in zip(tree.leaves(restored), tree.leaves(state)))
    del restored
    mesh41 = make_mesh((4, 1), MESH_AXES, device=dev)
    t0 = time.perf_counter()
    moved = elastic.reshard_state(state["params"], param_shardings(model, mesh41, rules))
    sync(dev)
    rec["reshard_s"] = time.perf_counter() - t0
    names = list(tree.flatten_with_names({"params": like["params"]}))
    equal, sharded = True, 0
    with np.load(os.path.join(ckpt, f"state_{step:08d}.npz")) as data:
        for name, t in zip(names, tree.leaves(moved)):
            full = _to_torch(data[name], t.dtype)
            off = model_layers._local_offsets(t)
            loc = t.to_local()
            block = full[tuple(slice(o, o + n) for o, n in zip(off, loc.shape))]
            equal &= same(loc.cpu(), block)
            sharded += any(pl.is_shard() for pl in t.placements)
    rec["reshard_equal"], rec["resharded_leaves"] = equal, sharded
    rec["printed"] = out.getvalue().splitlines()[-3:]
    return rec


def mesh_pipeline(rank: int, dev, mcfg: dict) -> dict:
    """(d) on a rank: ``pipeline_apply`` of four Qwen3-1.7B decoder blocks,
    one a rank on the axis ``pipe``, over PIPE_MICRO microbatches; rank 0
    also applies the blocks in sequence."""
    from repro_torch.models.model import _KINDS

    mesh = make_mesh((4,), ("pipe",), device=dev)
    cfg = mcfg["pipe"]
    dense = _KINDS["dense"]
    blocks = [dense["init"](torch.Generator(device=dev).manual_seed(SEED + 1400 + i), cfg, torch.bfloat16)
              for i in range(4)]
    x = (torch.randn((PIPE_MICRO, *mcfg["pipe_mb"]), generator=torch.Generator().manual_seed(SEED + 1410))
         .to(torch.bfloat16).to(dev))

    def stage(p, mb):
        return dense["fwd"](p, mb, cfg, model_layers.NO_CTX, 0.0)[0]

    stacked = stack_stage_params(blocks)
    sync(dev)
    t0 = time.perf_counter()
    out = pipeline_apply(stage, stacked, x, mesh=mesh, axis="pipe")
    sync(dev)
    rec = {"ms": (time.perf_counter() - t0) * 1e3, "shape": list(out.shape)}
    if rank == 0:
        t0 = time.perf_counter()
        ref = []
        for i in range(PIPE_MICRO):
            y = x[i]
            for b in blocks:
                y = stage(b, y)
            ref.append(y)
        ref = torch.stack(ref)
        sync(dev)
        rec["sequential_ms"] = (time.perf_counter() - t0) * 1e3
        rec["max_abs_err"] = float((out.float() - ref.float()).abs().max())
        rec["max_abs_ref"] = float(ref.float().abs().max())
        rec["bit_equal"] = same(out, ref)
        rec["finite"] = bool(torch.isfinite(out.float()).all())
    return rec


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def mesh_worker(rank: int, world: int, init: str, ckpt: str, mcfg: dict, go, out, device_type: str):
    """A rank of phase ``mesh``: joins the world (the port's staging backend
    on the card, gloo on the CPU), says it is ready, waits for the parent's
    go and runs (a)-(d), sending each part's result. Any error is sent to
    the parent, which fails the run."""
    try:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # every rank lives on this host
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))  # the ranks share the host's cores
        dev = torch.device("cpu")
        backend = "gloo"
        if device_type == "cuda":
            torch.cuda.set_device(0)
            dev = torch.device("cuda", 0)
            staging.register()
            backend = staging.BACKEND
        dist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
        torch.zeros(1, device=dev)
        out.put(("ready", rank, None, None))
        if not go.wait(MESH_DEADLINE_S):
            raise TimeoutError("the parent never said go")
        for part, fn in (("serve", lambda: mesh_serve(rank, dev, mcfg)), ("launcher", lambda: mesh_launcher(dev, mcfg)),
                         ("train_small", lambda: mesh_train_small(rank, dev)),
                         ("train_full", lambda: mesh_train_full(rank, dev, ckpt, mcfg)),
                         ("pipeline", lambda: mesh_pipeline(rank, dev, mcfg))):
            t0 = time.perf_counter()
            res = fn()
            res["seconds"] = time.perf_counter() - t0
            out.put(("ok", rank, part, res))
            if dev.type == "cuda":
                gc.collect()
                torch.cuda.empty_cache()
        dist.destroy_process_group()
        out.put(("done", rank, None, None))
    except BaseException:  # reported to the parent, which fails the run
        out.put(("error", rank, None, traceback.format_exc()))


def mesh_dry_tick(mcfg: dict) -> dict:
    """(e), in a process of its own: (a)'s tick (the decode step of the
    engine's config on MESH_SHAPE under its rules, SERVE_SLOTS slots, max_len,
    tokens and positions whole on every rank) counted by the dry run's
    counter on ``meta`` blocks of a fake world of four ranks standing for
    cards; then the same tick under ``CommDebugMode``."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.dist.counting import count_collectives, fake_world
    from repro_torch.launch.costpass import meta_blocks
    from repro_torch.train.train_loop import cache_shardings, param_shardings

    t0 = time.perf_counter()
    fake_world(math.prod(MESH_SHAPE))
    mesh = make_mesh(MESH_SHAPE, MESH_AXES, device="meta")
    cfg, max_len = mcfg["serve"], mcfg["max_len"]
    model = build_model(cfg)
    rules = mesh_rules(cfg, max_len)
    params = model.init(None, shardings=param_shardings(model, mesh, rules))
    cache = model.init_cache(SERVE_SLOTS, max_len, device="meta")
    cache = meta_blocks(cache, cache_shardings(model, mesh, rules, cache))
    toks = torch.empty((SERVE_SLOTS, 1), dtype=torch.int32, device="meta")
    pos = torch.empty((SERVE_SLOTS,), dtype=torch.int32, device="meta")
    dec = make_decode_step(model, rules, mesh=mesh)
    counter = count_collectives(dec, params, cache, toks, pos)
    with CommDebugMode() as cdm:
        dec(params, cache, toks, pos)
    return {"calls": counter.staged_calls(), "bytes": counter.staged_bytes(), "collectives": counter.collectives(),
            "comm_debug_mode": {str(k): int(v) for k, v in cdm.get_comm_counts().items()},
            "torch": torch.__version__, "seconds": time.perf_counter() - t0}


def mesh_dry_cell() -> dict:
    """(e), in a process of its own: MESH_DRY_CELL on the 256-rank production
    mesh through ``launch.dryrun`` (this process the fake world's rank 0)."""
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        rec = dryrun.dryrun_cell(*MESH_DRY_CELL, d, force=True, multi_pod=False)
        wall = time.perf_counter() - t0
    return {"record": {k: v for k, v in rec.items() if k not in ("op_cost", "traceback")}, "wall_s": wall}


def mesh_reference(dev, mcfg: dict) -> dict:
    """The parent's side: the one-process engine on the same weights and
    requests, on the card ((a), (b)), one prefill's and one tick's logits,
    the float32 smoke config's tokens, and the float32 smoke train run on
    the CPU ((c))."""
    cfg, max_len = mcfg["serve"], mcfg["max_len"]
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    eng = mesh_engine(model, params, mcfg)
    ref = {"tokens": tokens_of(eng.serve(mesh_requests(mcfg), greedy=True, sync_every=SERVE_SYNC))}
    probe = logits_probe(model, params, mesh_requests(mcfg)[0], max_len, mcfg["buckets"], None, None)
    ref["probe"] = {k: probe[k] for k in ("prefill", "tick")}
    del eng, params, probe
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    small = build_model(smoke_config(SERVE_ARCH).replace(dtype="float32", n_layers=2))
    sp = tree.map(lambda t: t.to(dev), small.init(torch.Generator().manual_seed(SEED + 1300)))
    seng = ContinuousEngine(small, sp, n_slots=2, max_len=32, buckets=(8, 16), max_new_tokens=8,
                            metrics=MetricsRegistry())
    ref["small_tokens"] = tokens_of(seng.serve(mesh_small_requests(), greedy=True, sync_every=3))
    tmodel = build_model(smoke_config(TRAIN_ARCH).replace(dtype="float32"))
    p = tmodel.init(torch.Generator().manual_seed(SEED + 1100))
    st = init_state(RESUME_OPT, p)
    step = make_train_step(tmodel, RESUME_OPT)
    ds = SyntheticLM(tmodel.cfg)
    losses, lrs = [], []
    for s in range(SMALL_TRAIN_STEPS):
        p, st, m = step(p, st, to_device(ds.batch(s, SMALL_TRAIN_BATCH, SMALL_TRAIN_SEQ), "cpu"))
        losses.append(float(m["loss"]))
        lrs.append(float(m["lr"]))
    ref["train_small"] = {"state": (p, st), "losses": losses, "lrs": lrs}
    return ref


def mesh_phase(mcfg: dict, dev) -> dict:
    """Phase ``mesh``: one spawned world of four ranks on the card runs
    (a)-(d) while the parent computes the one-process references; every
    check is the parent's. Returns the phase's record."""
    import multiprocessing as mp

    t0 = time.perf_counter()
    world = math.prod(MESH_SHAPE)
    ctx = mp.get_context("spawn")  # the parent has initialised CUDA: no fork
    tmp = tempfile.TemporaryDirectory()
    go, out = ctx.Event(), ctx.Queue()
    init = "file://" + os.path.join(tmp.name, "store")
    ckpt = os.path.join(tmp.name, "ckpt")
    procs = [ctx.Process(target=mesh_worker, args=(r, world, init, ckpt, mcfg, go, out, dev.type), daemon=True)
             for r in range(world)]
    results: dict = {}
    dry_pool = ProcessPoolExecutor(2, mp_context=ctx)  # (e): each count in a fake world of its own
    try:
        dry_tick, dry_cell = dry_pool.submit(mesh_dry_tick, mcfg), dry_pool.submit(mesh_dry_cell)
        for p in procs:
            p.start()
        t_ref = time.perf_counter()
        ref = mesh_reference(dev, mcfg)
        ref_s = time.perf_counter() - t_ref
        if dev.type == "cuda":
            gc.collect()
            torch.cuda.empty_cache()
        go.set()
        want, got, deadline = world * 7, 0, time.monotonic() + MESH_DEADLINE_S  # ready, 5 parts, done
        while got < want:
            try:
                status, rank, part, value = out.get(timeout=5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                check(not dead, f"mesh: rank(s) {dead} died (exit codes {[procs[r].exitcode for r in dead]})")
                check(time.monotonic() < deadline, f"mesh: the ranks did not finish within {MESH_DEADLINE_S} s")
                continue
            check(status != "error", f"mesh: rank {rank} raised:\n{value}")
            got += 1
            if status == "ok":
                results.setdefault(part, {})[rank] = value
                if rank == 0:  # progress, on the error stream
                    nums = {k: v for k, v in value.items() if isinstance(v, (int, float, dict)) and "tokens" not in k
                            and k not in ("probe", "state", "param_placements")}
                    print(f"chip_smoke: mesh/{part} done on rank 0 in {value['seconds']:.1f} s, "
                          f"{time.perf_counter() - t0:.1f} s into the phase: {json.dumps(nums, default=str)[:1500]}",
                          file=sys.stderr, flush=True)
        dry_tick, dry_cell = dry_tick.result(MESH_DEADLINE_S), dry_cell.result(MESH_DEADLINE_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(30)
        dry_pool.shutdown(cancel_futures=True)
        tmp.cleanup()
    phase_s = time.perf_counter() - t0
    ranks = range(world)

    # (e) the dry run's count of (a)'s tick against the staged calls; one production-mesh cell
    staged = results["serve"][0]["tick_staged"]  # the staging group stages CUDA tensors only: on the card
    check(dev.type != "cuda" or dry_tick["calls"] == staged["calls"] and dry_tick["bytes"] == staged["bytes"],
          f"mesh/dryrun: the dry run counts {dry_tick['calls']} calls of {dry_tick['bytes']} bytes a tick; "
          f"the staging group staged {staged['calls']} of {staged['bytes']}")
    cell = dry_cell["record"]
    check(cell["status"] == "ok" and cell["n_chips"] == 256 and cell["collective_bytes_per_device"] > 0,
          f"mesh/dryrun: {MESH_DRY_CELL} on pod16x16 is {cell.get('status')}: {cell.get('error')}")
    say("mesh_dryrun_cell", wall_s=dry_cell["wall_s"], record=cell)
    dry_rec = {"tick_calls": dry_tick["calls"], "tick_bytes": dry_tick["bytes"],
               "tick_collectives": dry_tick["collectives"], "staged_calls": staged["calls"],
               "staged_bytes": staged["bytes"], "comm_debug_mode_real_tick": results["serve"][0]["tick_collectives"],
               "comm_debug_mode_meta_tick": dry_tick["comm_debug_mode"], "torch": dry_tick["torch"],
               "count_s": dry_tick["seconds"], "cell_wall_s": dry_cell["wall_s"]}

    # (a) serving
    sv = results["serve"]
    toks = [sv[r]["tokens"] for r in ranks]
    check(all(t == toks[0] for t in toks), "mesh/serve: the ranks' tokens differ")
    equal_one = toks[0] == ref["tokens"]
    small_equal = all(sv[r]["small_tokens"] == ref["small_tokens"] for r in ranks)
    check(small_equal, "mesh/serve: the float32 smoke config's tokens differ from the one-process engine's")
    pr, rp = sv[0]["probe"], ref["probe"]
    lerr = {k: logits_err(pr[k], rp[k]) for k in ("prefill", "tick")}
    check(all(v["rms_of_rms"] <= REFEED_RMS_TOL and v["max_of_max"] <= REFEED_MAX_TOL for v in lerr.values()),
          f"mesh/serve: the full-width logits differ from one process's: {lerr}")
    n_same = sum(x == y for k in toks[0] for x, y in zip(toks[0][k], ref["tokens"][k]))
    serve_rec = {
        "arch": SERVE_ARCH, "layers": mcfg["serve"].n_layers, "mesh": dict(zip(MESH_AXES, MESH_SHAPE)),
        "slots": SERVE_SLOTS,
        "max_len": mcfg["max_len"], "buckets": mcfg["buckets"], "requests": MESH_REQUESTS + len(MESH_PROMPTS),
        "max_new": MESH_MAX_NEW,
        "tokens_equal_across_ranks": True, "tokens_equal_one_process": equal_one,
        "tokens_first_divergence": None if equal_one else first_divergence(toks[0], ref["tokens"]),
        "tokens_same_one_process": [n_same, sum(len(v) for v in toks[0].values())],
        "small_float32_tokens_equal": small_equal, "logits_err": lerr,
        "logits_tolerance": {"rms_of_rms": REFEED_RMS_TOL, "max_of_max": REFEED_MAX_TOL},
        "tokens_per_s": [sv[r]["tokens_per_s"] for r in ranks], "decode_steps": sv[0]["decode_steps"],
        "wall_s": sv[0]["wall_s"], "ttft_ms": sv[0]["ttft_ms"], "tick_ms": [sv[r]["tick_ms"] for r in ranks],
        "prefill_ms": sv[0]["prefill_ms"], "counted_tick_ms": sv[0]["counted_tick_ms"],
        "tick_collectives": sv[0]["tick_collectives"], "tick_staged": sv[0]["tick_staged"],
        "init_s": [sv[r]["init_s"] for r in ranks], "held_bytes": [sv[r]["held_bytes"] for r in ranks],
        "peak_bytes": [sv[r]["peak_bytes"] for r in ranks], "b0_placements": sv[0]["param_placements"],
        "seconds": [sv[r]["seconds"] for r in ranks]}

    # (b) the launcher: its tokens are the first MESH_LAUNCHER_NEW of (a)'s for its prompts
    ln = results["launcher"]
    cut = {k: v[:len(MESH_PROMPTS[int(k[4:])]) + MESH_LAUNCHER_NEW] for k, v in toks[0].items() if k.startswith("cli-")}
    check(all(ln[r]["tokens"] == cut for r in ranks),
          f"mesh/launcher: launch/serve.py --mesh 2x2 gives other tokens than (a)'s engine: {ln[0]['tokens']} {cut}")
    check(any("cli-0" in line for line in ln[0]["printed"]) and not any(ln[r]["printed"] for r in ranks if r),
          "mesh/launcher: rank 0 alone must print the sequences")
    launcher_rec = {"tokens_equal_engine": True, "max_new": MESH_LAUNCHER_NEW, "printed": ln[0]["printed"],
                    "seconds": [ln[r]["seconds"] for r in ranks]}

    # (c) training
    ts = results["train_small"]
    cp, cs = ref["train_small"]["state"]
    gp, gs = ts[0]["state"]
    check(all(ts[r]["on_mesh"] for r in ranks), "mesh/train: the state left the mesh")
    check(all(ts[r]["losses"] == ts[0]["losses"] for r in ranks), "mesh/train: the ranks' losses differ")
    worst, tol = small_errors(gp, gs, ts[0]["losses"], cp, cs, ref["train_small"]["losses"], ref["train_small"]["lrs"])
    check(int(gs["step"]) == SMALL_TRAIN_STEPS and all(worst[k] <= tol[k] for k in worst),
          f"mesh/train: the 2x2 step and the CPU's differ: {worst} against {tol}")
    tf = results["train_full"]
    check(all(tf[r]["restored_equal"] and tf[r]["reshard_equal"] for r in ranks),
          "mesh/train: the restored or resharded state is not bit-equal to the checkpoint")
    check(all(tf[r]["restored_step"] == MESH_TRAIN_STEPS for r in ranks), "mesh/train: restored the wrong step")
    losses = [h["loss"] for h in tf[0]["history"]]
    check(all(math.isfinite(v) for v in losses), f"mesh/train: full-width losses not finite: {losses}")
    hist = tf[0]["history"]
    train_rec = {"small": {"config": "qwen3-1.7b smoke, float32", "losses_mesh": ts[0]["losses"],
                           "losses_cpu": ref["train_small"]["losses"], "max_err": worst, "tolerance": tol,
                           "seconds": ts[0]["seconds"]},
                 "full": {"layers": MESH_TRAIN_LAYERS, "steps": MESH_TRAIN_STEPS, "batch": [8, 256],
                          "losses": losses, "step_ms": [(b["s"] - a) * 1e3 for a, b in
                                                        zip([0.0] + [h["s"] for h in hist[:-1]], hist)],
                          "peak_bytes": [tf[r]["peak_bytes"] for r in ranks],
                          "held_bytes": [tf[r]["held_bytes"] for r in ranks],
                          "restore_s": tf[0]["restore_s"], "reshard_s": tf[0]["reshard_s"],
                          "restore_bit_equal": True, "reshard_4x1_bit_equal": True,
                          "resharded_leaves": tf[0]["resharded_leaves"], "seconds": tf[0]["seconds"]}}

    # (d) the pipeline
    pl = results["pipeline"][0]
    check(pl["finite"] and pl["max_abs_err"] <= PIPE_TOL * pl["max_abs_ref"],
          f"mesh/pipeline: GPipe differs from the blocks in sequence by {pl['max_abs_err']}")
    pipe_rec = {**pl, "stages": 4, "microbatches": PIPE_MICRO, "microbatch": list(PIPE_MB),
                "tolerance_of_largest": PIPE_TOL}
    check(phase_s <= MESH_PHASE_S, f"mesh: the phase took {phase_s:.1f} s, over {MESH_PHASE_S} s")
    return {"serve": serve_rec, "launcher": launcher_rec, "train": train_rec, "pipeline": pipe_rec,
            "dryrun": dry_rec, "reference_s": ref_s, "seconds": phase_s}


def first_divergence(a: dict, b: dict):
    """(request, index) of the first token where two runs' tokens part."""
    for k in sorted(a):
        for i, (x, y) in enumerate(zip(a[k], b.get(k, ()))):
            if x != y:
                return [k, i]
    return None


# ---------------------------------------------------------------------------
# phase 16: the coded guards on the (data=2, model=2) mesh of four ranks
# ---------------------------------------------------------------------------

# (a), (b): the serve trace's first 4 requests (426, 75, 239, 110 tokens), 12 new tokens each (16 cut to 12
# for time: three chunks, the kill after tick 8 found at the third)
CM_REQUESTS, CM_MAX_NEW = 4, 12
CM_K, CM_R, CM_KILLS = 2, 2, ((8, 3),)  # (b): the rank form, N = 4 hosts = the four ranks; host 3 dies after tick 8
# (b'): the rank form over all three ports (one round, radix 4: butterfly_mac on every rank), one
# snapshot of the state (b) leaves; its recovery is (b)'s host numpy decode, which p does not change
CM_WIDE_P = 3
CM_LAUNCH_NEW = 8  # (c): two chunks of 4 ticks: the kills after ticks 2 and 6 are found at their ends
CM_LAUNCH_K, CM_LAUNCH_R = 3, 2
CM_LAUNCH_CODED = ["--coded", f"{CM_LAUNCH_K},{CM_LAUNCH_R}", "--kill", "2:0", "--kill", "6:4"]
CM_TRAIN_STEPS, CM_TRAIN_K, CM_TRAIN_LOST = 3, 8, [1, 4, 6]  # (d): the launcher's --coded-k default
# (d'): the train guard at full width, one of 28 layers, 2 steps of 8 x 256: one snapshot, after step 1
CM_FULL_LAYERS, CM_FULL_STEPS, CM_FULL_BATCH, CM_FULL_SEQ = 1, 2, 8, 256
CM_FULL_BLOCKS = 3  # (d'): random column blocks rank 0 holds, beside the first and the last
CM_DEADLINE_S = 600  # the whole phase: a rank that has not answered by then fails the run
# what the phase may take: 158 and 226 s on two hosts before (b') lost its recovery (14 s); most of the
# rest is host numpy (four Lagrange decodes of 11-14 s each), which moves with the host
CM_PHASE_S = 240
CM_ENTRIES = {"ranks": "CodedServeGuard(mesh=hosts).snapshot",
              "wide": "CodedServeGuard(mesh=hosts, p=3).snapshot", "launch": "launch/serve.py --mesh 2x2 --coded 3,2",
              "train": "launch/train.py --mesh 2x2 --smoke --coded-every 1",
              "train_full": "launch/train.py --mesh 2x2 --layers 1 --coded-every 1"}


def cm_state_spec(model, max_new: int) -> tuple:
    """(cache, state) a continuous engine of SERVE_SLOTS slots, max_len
    SERVE_POSITIONS and this budget hands the guard, as meta tensors."""
    eng = ContinuousEngine(model, model.param_specs(), n_slots=SERVE_SLOTS, max_len=SERVE_POSITIONS,
                           buckets=MESH_BUCKETS, max_new_tokens=max_new)
    return model.init_cache(SERVE_SLOTS, SERVE_POSITIONS, device="meta"), eng.init_state()


def coded_mesh_config() -> dict:
    """Phase ``coded_mesh``'s configuration, handed to every rank: the
    served model (Qwen3-1.7B, MESH_LAYERS layers), max_len, buckets and the trace's mix,
    the launchers' extra flags, each guard's shard width ``S`` and the
    kernel calls of one snapshot of each guard (``paths``, for phase 3: the
    rank form's on each rank, batch 1; the launcher's single-program guard
    and the train guard on rank 0)."""
    cfg = get(SERVE_ARCH).replace(n_layers=MESH_LAYERS)
    model = build_model(cfg)
    rplan, lplan = build_lcc(CM_K, R=CM_R), build_lcc(CM_LAUNCH_K, R=CM_LAUNCH_R)
    wplan = build_lcc(CM_K, p=CM_WIDE_P, R=CM_R)
    lps = plan_prepare_shoot(lplan.N, lplan.p)
    small = build_model(smoke_config(TRAIN_ARCH))
    ocfg = OptConfig(total_steps=CM_TRAIN_STEPS)
    tplan = build_parity_plan(CM_TRAIN_K)
    full = build_model(get(TRAIN_ARCH).replace(n_layers=CM_FULL_LAYERS))
    focfg = OptConfig(total_steps=CM_FULL_STEPS)
    S = {"ranks": -(-limb_count(cm_state_spec(model, CM_MAX_NEW)) // CM_K),
         "launch": -(-limb_count(cm_state_spec(model, CM_LAUNCH_NEW)) // CM_LAUNCH_K),
         "train": -(-limb_count({"params": small.param_specs(), "opt": state_specs(ocfg, small.param_specs())})
                    // CM_TRAIN_K),
         "train_full": -(-limb_count({"params": full.param_specs(), "opt": state_specs(focfg, full.param_specs())})
                         // CM_TRAIN_K)}

    def rank_calls(plan):
        return ir_kernel_calls(plan_prepare_shoot(plan.N, plan.p).to_ir(lcc_generator(plan), q=NTT), S["ranks"],
                               batch=1)

    runs = {"ranks": rank_calls(rplan), "wide": rank_calls(wplan),
            "launch": in_blocks(lambda w: [("gf_matmul", (lplan.N, lps.n, lps.m, w))], S["launch"], lplan.N),
            "train": in_blocks(lambda w: [("gf_matmul", (CM_TRAIN_K, tplan.ps_plan.n, tplan.ps_plan.m, w))], S["train"],
                               CM_TRAIN_K),
            "train_full": in_blocks(lambda w: [("gf_matmul", (CM_TRAIN_K, tplan.ps_plan.n, tplan.ps_plan.m, w))],
                                    S["train_full"], CM_TRAIN_K)}
    return {"serve": cfg, "max_len": SERVE_POSITIONS, "buckets": MESH_BUCKETS, "mix": SERVE_MIX, "S": S,
            "launcher_extra": [], "train_extra": [], "runs": runs,
            "paths": [{"name": "coded_mesh", "q": NTT, "runs": {CM_ENTRIES[k]: runs[k] for k in ("ranks", "wide", "launch")}},
                      {"name": "coded_mesh", "q": M31, "runs": {CM_ENTRIES[k]: runs[k] for k in ("train", "train_full")}}]}


def cm_requests(mcfg: dict) -> list:
    """The serve trace's first CM_REQUESTS requests, budget CM_MAX_NEW, all
    arrived: they fill the four slots at once, on every rank alike."""
    trace = poisson_trace(SERVE_REQUESTS, SERVE_RATE, mix=mcfg["mix"], max_new_tokens=SERVE_MAX_NEW,
                          vocab_size=mcfg["serve"].vocab_size, seed=SEED + 1001)[:CM_REQUESTS]
    return [dataclasses.replace(r, max_new_tokens=CM_MAX_NEW, arrival_s=0.0) for r in trace]


def zero_launches():
    gf_matmul_cuda.launches = 0
    butterfly_mac_rows_cuda.launches = 0


def launch_counts() -> dict:
    return {"gf_matmul": gf_matmul_cuda.launches, "butterfly_mac": butterfly_mac_rows_cuda.launches}


@contextlib.contextmanager
def guard_calls(cls, sink: dict, memory: bool = False):
    """Time every ``snapshot`` and ``recover`` of guards of ``cls`` while the
    block runs (wall ms into ``sink["snapshot_ms"]``, ``sink["recover_ms"]``),
    and keep the width of the coded shards a snapshot leaves on this rank.
    With ``memory``, on the card, each snapshot's device bytes go into
    ``sink["memory"]`` (held as it starts, peak, added, and the bytes of the
    state it read, ``state_bytes``) and the peak of what ran before the last
    one into ``sink["before_peak_bytes"]`` (each snapshot resets the peak)."""
    snap, rec = cls.snapshot, getattr(cls, "recover", None)

    def snapshot(self, *a, **kw):
        on_card = memory and self.device.type == "cuda"
        if on_card:
            torch.cuda.synchronize()
            sink["before_peak_bytes"] = max(sink.get("before_peak_bytes", 0), torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            held_bytes = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        snap(self, *a, **kw)
        sink.setdefault("snapshot_ms", []).append((time.perf_counter() - t0) * 1e3)
        if on_card:
            torch.cuda.synchronize()
            pk = torch.cuda.max_memory_allocated()
            meta = self._meta
            sink.setdefault("memory", []).append({
                "held_bytes": held_bytes, "peak_bytes": pk, "added_bytes": pk - held_bytes,
                "state_bytes": sum(math.prod(sh) * dt.itemsize for sh, dt in zip(meta.shapes, meta.dtypes))})
        held = getattr(self, "group", None)
        if held is not None and held._mem:
            sink["width"] = len(next(iter(held._mem.values())))

    def recover(self, *a, **kw):
        t0 = time.perf_counter()
        out = rec(self, *a, **kw)
        sink.setdefault("recover_ms", []).append((time.perf_counter() - t0) * 1e3)
        return out

    cls.snapshot = snapshot
    if rec is not None:
        cls.recover = recover
    try:
        yield sink
    finally:
        cls.snapshot = snap
        if rec is not None:
            cls.recover = rec


def one_program_rows(whole, plan, dev) -> np.ndarray:
    """The coded rows of a whole (cache, state) through the one-program
    ``lcc_encode`` on ``dev``: what a rank-form snapshot is held against."""
    shards, _ = shard_state_limbs(tree.map(lambda t: t.to(dev), whole), plan.K, dev)
    rows = to_numpy(lcc_encode(plan, shards))
    del shards
    return rows


def cm_serve(rank: int, dev, mcfg: dict) -> dict:
    """(a), (b) and (b') on a rank: Qwen3-1.7B at MESH_LAYERS layers on the 2x2 mesh, the
    trace unguarded, then under ``CodedServeGuard(K=2, R=2, mesh=hosts,
    axis="hosts")`` over the four ranks (a gloo group), host 3 killed after
    tick 8; then one snapshot of the state (b) leaves by the rank form at p
    = 3. Rank 0 keeps the state and the coded rows of (b)'s first snapshot
    and of (b')'s, and encodes each state with the one-program ``lcc_encode``
    once the counted run is over (those launches and bytes are not the
    guard's)."""
    mesh = make_mesh(MESH_SHAPE, MESH_AXES, device=dev)
    hosts = make_mesh((math.prod(MESH_SHAPE),), ("hosts",), group=dist.new_group(backend="gloo"), device=dev)
    cfg, max_len = mcfg["serve"], mcfg["max_len"]
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    eng = ContinuousEngine(model, params, n_slots=SERVE_SLOTS, max_len=max_len, buckets=mcfg["buckets"],
                           max_new_tokens=CM_MAX_NEW, mesh=mesh, rules=mesh_rules(cfg, max_len),
                           metrics=MetricsRegistry())
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out = {"held_bytes": local_bytes(eng.params), "init_s": time.perf_counter() - t0}
    sync(dev)
    rep = eng.serve(cm_requests(mcfg), greedy=True, sync_every=SERVE_SYNC)
    out["plain"] = {"tokens": tokens_of(rep), "tokens_per_s": rep.tokens_per_s, "wall_s": rep.wall_s,
                    "decode_steps": rep.decode_steps}
    plan = build_lcc(CM_K, R=CM_R)
    guard = CodedServeGuard(K=CM_K, R=CM_R, injector=FaultInjector(kills=CM_KILLS), mesh=hosts, axis="hosts")
    first: dict = {}
    calls: dict = {}
    host_ms: list = []
    sync(dev)
    reset_peak(dev)
    zero_launches()
    with guard_calls(CodedServeGuard, calls), timed(serve_coded, "lcc_decode", host_ms):
        snap = guard.snapshot

        def snapshot(cache, state, tick):
            first["last"] = (cache, state)
            if "rows" in first:
                return snap(cache, state, tick)
            whole = gather_state((cache, state), keep=rank == 0)  # every rank: the gathers are collective
            # a copy: on the CPU ``.cpu()`` is the same tensor, which the engine updates in place
            first["whole"] = None if whole is None else tree.map(lambda t: t.to("cpu", copy=True), whole)
            del whole
            snap(cache, state, tick)
            first["rows"] = [guard.group._mem[j] for j in range(plan.N)] if rank == 0 else None

        guard.snapshot = snapshot
        rep = eng.serve(cm_requests(mcfg), greedy=True, sync_every=SERVE_SYNC, guard=guard)
    sync(dev)
    out["guarded"] = {"tokens": tokens_of(rep), "tokens_per_s": rep.tokens_per_s, "wall_s": rep.wall_s,
                      "stats": rep.coded, "alive": sorted(guard.alive), "launches": launch_counts(),
                      "snapshot_ms": calls["snapshot_ms"], "recover_ms": calls.get("recover_ms", []),
                      "lcc_decode_host_ms": host_ms, "width": calls.get("width"), "peak_bytes": peak(dev),
                      "host": guard._host, "kernels": guard._ranks.kernels, "transport": guard._ranks.transport,
                      "calls": ir_kernel_calls(guard._ranks.ir, mcfg["S"]["ranks"], batch=1)}

    # (b'): the rank form at p = 3 on the (cache, state) (b)'s last snapshot was handed, as (b) left them
    cache, state = first.pop("last")
    wide = CodedServeGuard(K=CM_K, R=CM_R, p=CM_WIDE_P, mesh=hosts, axis="hosts")
    sync(dev)
    reset_peak(dev)
    zero_launches()
    t0 = time.perf_counter()
    wide.snapshot(cache, state, tick=0)
    sync(dev)
    out["wide"] = {"launches": launch_counts(), "snapshot_ms": (time.perf_counter() - t0) * 1e3,
                   "peak_bytes": peak(dev), "kernels": wide._ranks.kernels,
                   "calls": ir_kernel_calls(wide._ranks.ir, mcfg["S"]["ranks"], batch=1),
                   "width": len(next(iter(wide.group._mem.values()))) if wide.group._mem else None}
    last = gather_state((cache, state), keep=rank == 0)
    del cache, state
    if rank == 0:  # both states through the one-program encode, after the counted runs
        t0 = time.perf_counter()
        want = one_program_rows(first.pop("whole"), plan, dev)
        out["guarded"]["rows_equal_one_program"] = all(np.array_equal(want[j], first["rows"][j]) for j in range(plan.N))
        out["guarded"]["row_hashes"] = [row_hash(r) for r in first["rows"]]
        want = one_program_rows(last, wide.plan, dev)  # its own plan: the ω points are drawn for its p
        out["wide"]["rows_equal_one_program"] = all(np.array_equal(want[j], wide.group._mem[j]) for j in range(plan.N))
        out["compare_s"] = time.perf_counter() - t0
    return out


def cm_launcher(rank: int, dev, mcfg: dict) -> dict:
    """(c) on a rank: ``launch/serve.py --mesh 2x2 --profile opt`` on phase
    ``mesh``'s two prompts, without and with ``--coded 3,2 --kill 2:0
    --kill 6:4`` (rank 0 prints)."""
    argv = ["--arch", SERVE_ARCH, "--layers", str(MESH_LAYERS), "--mesh", "2x2", "--max-new", str(CM_LAUNCH_NEW),
            "--max-len", str(mcfg["max_len"]), "--profile", "opt",
            "--prompts", ";".join(",".join(map(str, p)) for p in MESH_PROMPTS), *mcfg["launcher_extra"]]
    res = {}
    for name, extra in (("plain", []), ("coded", CM_LAUNCH_CODED)):
        calls: dict = {}
        buf = io.StringIO()
        sync(dev)
        reset_peak(dev)
        zero_launches()
        t0 = time.perf_counter()
        with guard_calls(CodedServeGuard, calls, memory=True), contextlib.redirect_stdout(buf):
            rep = serve_main(argv + extra)
        sync(dev)
        res[name] = {"tokens": tokens_of(rep), "printed": buf.getvalue().splitlines(), "stats": rep.coded,
                     "launches": launch_counts(), "seconds": time.perf_counter() - t0,
                     "peak_bytes": max(peak(dev), calls.get("before_peak_bytes", 0)),
                     "snapshot_ms": calls.get("snapshot_ms", []), "recover_ms": calls.get("recover_ms", []),
                     "snapshot_memory": calls.get("memory", []), "width": calls.get("width")}
        del rep
        if dev.type == "cuda":
            gc.collect()
            torch.cuda.empty_cache()
    return res


def cm_train(rank: int, dev, mcfg: dict) -> dict:
    """(d) on a rank: ``launch/train.py --mesh 2x2 --smoke --coded-every 1``
    for CM_TRAIN_STEPS steps; rank 0's shards and parity against a
    one-process guard's over the gathered state (on the CPU: no launch); then
    ``fail_and_recover(CM_TRAIN_LOST)`` and ``reshard_state`` onto the run's
    shardings, each rank's blocks against those it held."""
    from repro_torch.coded.rs_checkpoint import gather_state

    argv = ["--arch", TRAIN_ARCH, "--mesh", "2x2", "--smoke", "--coded-every", "1", "--steps", str(CM_TRAIN_STEPS),
            "--batch", str(SMALL_TRAIN_BATCH), "--seq", str(SMALL_TRAIN_SEQ), *mcfg["train_extra"]]
    calls: dict = {}
    sync(dev)
    reset_peak(dev)
    zero_launches()
    with guard_calls(CodedStateGuard, calls, memory=True), contextlib.redirect_stdout(io.StringIO()):
        run = train_main(argv)
    sync(dev)
    rec = {"launches": launch_counts(), "losses": [h["loss"] for h in run["history"]],
           "snapshot_ms": calls.get("snapshot_ms", []), "snapshot_memory": calls.get("memory", []),
           "peak_bytes": max(peak(dev), calls.get("before_peak_bytes", 0)), "held_bytes": local_bytes(run["state"])}
    g, final = run["guard"], run["state"]
    rec.update(step=g.step, holds=g._shards is not None,
               width=None if g._shards is None else int(g._shards.shape[1]))
    one = gather_state(final, keep=rank == 0)
    if rank == 0:
        og = CodedStateGuard(K=CM_TRAIN_K, device="cpu")
        og.snapshot(tree.map(lambda t: t.cpu(), one), g.step)
        rec["one_process_equal"] = bool(np.array_equal(og._shards, g._shards) and np.array_equal(og._parity, g._parity))
    del one
    t0 = time.perf_counter()
    back, step = g.fail_and_recover(CM_TRAIN_LOST)
    sync(dev)
    rec["recover_ms"] = (time.perf_counter() - t0) * 1e3
    mesh = make_mesh(MESH_SHAPE, MESH_AXES, device=dev)
    model, rules, ocfg = run["model"], run["rules"], run["opt_cfg"]
    placed = elastic.reshard_state(back, {"params": param_shardings(model, mesh, rules),
                                          "opt": opt_state_shardings(ocfg, model, mesh, rules)})
    rec["recovered_step"] = step
    rec["blocks_equal"] = all(
        isinstance(a, DTensor) and isinstance(b, DTensor) and tuple(a.placements) == tuple(b.placements)
        and a.to_local().shape == b.to_local().shape
        and same(a.to_local().reshape(-1).view(torch.uint8), b.to_local().reshape(-1).view(torch.uint8))
        for a, b in zip(tree.leaves(placed), tree.leaves(final)))
    rec["raise"] = cm_train_raise(rank, g, final, back)
    return rec


def cm_train_raise(rank: int, g, state, back) -> dict:
    """(d), a raise on the root: one more snapshot of ``state`` with rank
    0's encode made to raise (``elastic.encode_parity`` wrapped on rank 0
    alone). Every rank must raise, keep the last snapshot's step and recover
    ``back`` (the last snapshot's recovery) bit for bit: this rank's error,
    step, recovered step and whether its recovery equals ``back``."""
    real = elastic.encode_parity

    def fail(*args, **kwargs):
        raise MemoryError("the root's encode, made to raise")

    t0 = time.perf_counter()
    if rank == 0:
        elastic.encode_parity = fail
    try:
        g.snapshot(state, g.step + 1)
        raised = None
    except Exception as e:  # every rank's error, checked by the parent
        raised = f"{type(e).__name__}: {e}"
    finally:
        elastic.encode_parity = real
    again, step = g.fail_and_recover(CM_TRAIN_LOST)
    equal = all(a.dtype == b.dtype and a.shape == b.shape
                and same(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
                for a, b in zip(tree.leaves(again), tree.leaves(back)))
    return {"raised": raised, "step": g.step, "recovered_step": step, "recovered_equal": equal,
            "seconds": time.perf_counter() - t0}


def cm_train_full(rank: int, dev, mcfg: dict) -> dict:
    """(d') on a rank: ``launch/train.py --mesh 2x2 --layers 1 --coded-every
    1`` at full width for CM_FULL_STEPS steps of 8 x 256: one snapshot of
    the meshed state, gathered to rank 0 and encoded there in column blocks.
    Rank 0 then gathers the final state again and holds the first, the last
    and CM_FULL_BLOCKS random blocks of its shards against the state's limbs
    and of its parity against the plain ``x @ A mod q`` on the card."""
    from repro_torch.coded.rs_checkpoint import gather_state

    argv = ["--arch", TRAIN_ARCH, "--mesh", "2x2", "--layers", str(CM_FULL_LAYERS), "--coded-every", "1",
            "--steps", str(CM_FULL_STEPS), "--batch", str(CM_FULL_BATCH), "--seq", str(CM_FULL_SEQ),
            *mcfg["train_extra"]]
    calls: dict = {}
    sync(dev)
    reset_peak(dev)
    zero_launches()
    with guard_calls(CodedStateGuard, calls, memory=True), contextlib.redirect_stdout(io.StringIO()):
        run = train_main(argv)
    sync(dev)
    g, final = run["guard"], run["state"]
    rec = {"launches": launch_counts(), "losses": [h["loss"] for h in run["history"]], "step": g.step,
           "snapshot_ms": calls.get("snapshot_ms", []), "snapshot_memory": calls.get("memory", []),
           "peak_bytes": max(peak(dev), calls.get("before_peak_bytes", 0)), "held_bytes": local_bytes(final),
           "holds": g._shards is not None, "width": None if g._shards is None else int(g._shards.shape[1])}
    one = gather_state(final, keep=rank == 0)
    if rank == 0:
        K, S = g._shards.shape
        leaves = tree.leaves(one)
        blocks = column_blocks(S, K)
        rng = np.random.default_rng(SEED + 1400)
        picked = sorted({0, len(blocks) - 1} | set(rng.choice(len(blocks), CM_FULL_BLOCKS).tolist()))
        gt = to_tensor(np.ascontiguousarray(np.asarray(g.plan.A).T).astype(np.uint32), dev)
        shards_equal = parity_equal = True
        for i in picked:
            lo, hi = blocks[i]
            x = plain_block(leaves, K, S, lo, hi, dev)
            held = torch.from_numpy(np.ascontiguousarray(g._shards[:, lo:hi]).view(np.int32)).to(dev)
            par = torch.from_numpy(np.ascontiguousarray(g._parity[:, lo:hi]).view(np.int32)).to(dev)
            shards_equal &= same(x, held)
            parity_equal &= same(gf_matmul_plain(gt[None], x[None], M31)[0], par)
        rec.update(blocks=len(blocks), blocks_checked=picked, shards_equal=shards_equal, parity_equal=parity_equal,
                   host_bytes=g._shards.nbytes + g._parity.nbytes)
        del leaves, x, held, par
    del one, run, g, final
    return rec


def untokened(value):
    """A part's result without its tokens, printed lines and hashes."""
    if isinstance(value, dict):
        return {k: untokened(v) for k, v in value.items()
                if k not in ("tokens", "printed", "row_hashes", "calls", "probe", "state")}
    return value


def coded_mesh_worker(rank: int, world: int, init: str, mcfg: dict, go, out, device_type: str):
    """A rank of phase ``coded_mesh``: joins the world (the port's staging
    backend on the card, gloo on the CPU), says it is ready, waits for the
    parent's go and runs (a)-(d), sending each part's result. Any error is
    sent to the parent, which fails the run."""
    try:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # every rank lives on this host
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))  # the ranks share the host's cores
        dev = torch.device("cpu")
        backend = "gloo"
        if device_type == "cuda":
            torch.cuda.set_device(0)
            dev = torch.device("cuda", 0)
            staging.register()
            backend = staging.BACKEND
        dist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
        torch.zeros(1, device=dev)
        out.put(("ready", rank, None, None))
        if not go.wait(CM_DEADLINE_S):
            raise TimeoutError("the parent never said go")
        for part, fn in (("serve", cm_serve), ("launcher", cm_launcher), ("train", cm_train),
                         ("train_full", cm_train_full)):
            t0 = time.perf_counter()
            res = fn(rank, dev, mcfg)
            res["seconds"] = time.perf_counter() - t0
            out.put(("ok", rank, part, res))
            if dev.type == "cuda":
                gc.collect()
                torch.cuda.empty_cache()
        dist.destroy_process_group()
        out.put(("done", rank, None, None))
    except BaseException:  # reported to the parent, which fails the run
        out.put(("error", rank, None, traceback.format_exc()))


def coded_mesh_phase(mcfg: dict, dev) -> tuple[dict, dict]:
    """Phase ``coded_mesh``: one spawned world of four ranks on the card
    runs (a)-(d); every check is the parent's. Returns (the launches of the
    guards' kernels, summed over the ranks, the phase's record)."""
    import multiprocessing as mp

    t0 = time.perf_counter()
    world = math.prod(MESH_SHAPE)
    ctx = mp.get_context("spawn")  # the parent has initialised CUDA: no fork
    tmp = tempfile.TemporaryDirectory()
    go, out = ctx.Event(), ctx.Queue()
    init = "file://" + os.path.join(tmp.name, "store")
    procs = [ctx.Process(target=coded_mesh_worker, args=(r, world, init, mcfg, go, out, dev.type), daemon=True)
             for r in range(world)]
    results: dict = {}
    try:
        for p in procs:
            p.start()
        go.set()
        want, got, deadline = world * 6, 0, time.monotonic() + CM_DEADLINE_S  # ready, 4 parts, done
        while got < want:
            try:
                status, rank, part, value = out.get(timeout=5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                check(not dead, f"coded_mesh: rank(s) {dead} died (exit codes {[procs[r].exitcode for r in dead]})")
                check(time.monotonic() < deadline, f"coded_mesh: the ranks did not finish within {CM_DEADLINE_S} s")
                continue
            check(status != "error", f"coded_mesh: rank {rank} raised:\n{value}")
            got += 1
            if status == "ok":
                results.setdefault(part, {})[rank] = value
                if rank == 0:  # progress, on the error stream
                    print(f"chip_smoke: coded_mesh/{part} done on rank 0 in {value['seconds']:.1f} s, "
                          f"{time.perf_counter() - t0:.1f} s into the phase: "
                          f"{json.dumps(untokened(value), default=str)[:3000]}", file=sys.stderr, flush=True)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(30)
        tmp.cleanup()
    phase_s = time.perf_counter() - t0
    ranks = range(world)
    on_card = dev.type == "cuda"
    counted = {"gf_matmul": 0, "butterfly_mac": 0}

    def add(launches: dict):
        for k in counted:
            counted[k] += launches[k]

    # (a) and (b): the rank form's tokens equal the unguarded run's on every rank
    sv = results["serve"]
    base = sv[0]["plain"]["tokens"]
    check(all(sv[r]["plain"]["tokens"] == base for r in ranks), "coded_mesh/serve: the ranks' unguarded tokens differ")
    check(all(sv[r]["guarded"]["tokens"] == base for r in ranks),
          "coded_mesh/serve: the guarded tokens differ from the unguarded run's")
    g0 = sv[0]["guarded"]
    check(g0["rows_equal_one_program"],
          "coded_mesh/serve: the rank form's first coded rows differ from the one-program lcc_encode of the same limbs")
    check(all(sv[r]["guarded"]["stats"]["recoveries"] == 1 and sv[r]["guarded"]["alive"] == [0, 1, 2]
              and sv[r]["guarded"]["host"] == r for r in ranks),
          f"coded_mesh/serve: guard stats {[sv[r]['guarded']['stats'] for r in ranks]}")
    check(g0["width"] == mcfg["S"]["ranks"],
          f"coded_mesh/serve: the coded rows are {g0['width']} limbs wide, not the {mcfg['S']['ranks']} phase 3 held")
    snaps = g0["stats"]["snapshots"]
    for r in ranks:
        gr = sv[r]["guarded"]
        check(gr["calls"] == mcfg["runs"]["ranks"], f"coded_mesh/serve: rank {r} runs other kernels than phase 3 held")
        want = count_calls(mcfg["runs"]["ranks"])
        check(not on_card or (gr["kernels"] == "cuda"
                              and (gr["launches"]["gf_matmul"], gr["launches"]["butterfly_mac"])
                              == (want[0] * snaps, want[1] * snaps)),
              f"coded_mesh/serve: rank {r} launched {gr['launches']}, expected {want} a snapshot x {snaps}")
        add(gr["launches"])
    want = count_calls(mcfg["runs"]["wide"])
    check(sv[0]["wide"]["rows_equal_one_program"],
          f"coded_mesh/serve: the p={CM_WIDE_P} rank form's rows differ from the one-program lcc_encode")
    for r in ranks:
        w = sv[r]["wide"]
        check(w["calls"] == mcfg["runs"]["wide"], f"coded_mesh/serve: rank {r} runs other kernels at p={CM_WIDE_P}")
        check(not on_card or (w["kernels"] == "cuda" and (w["launches"]["gf_matmul"], w["launches"]["butterfly_mac"])
                              == want), f"coded_mesh/serve: rank {r} launched {w['launches']} at p={CM_WIDE_P}")
        add(w["launches"])
    check(sv[0]["wide"]["width"] == mcfg["S"]["ranks"], "coded_mesh/serve: the p=3 rows are not the width phase 3 held")
    serve_rec = {
        "arch": SERVE_ARCH, "layers": mcfg["serve"].n_layers, "mesh": dict(zip(MESH_AXES, MESH_SHAPE)),
        "slots": SERVE_SLOTS, "max_len": mcfg["max_len"],
        "requests": [len(r.prompt) for r in cm_requests(mcfg)], "max_new": CM_MAX_NEW, "K": CM_K, "R": CM_R,
        "kills": CM_KILLS, "tokens_equal_unguarded_every_rank": True, "rows_equal_one_program": True,
        "row_limbs": g0["width"], "row_hashes": g0["row_hashes"],
        "unguarded": {k: sv[0]["plain"][k] for k in ("tokens_per_s", "wall_s", "decode_steps")},
        "guarded": {"tokens_per_s": g0["tokens_per_s"], "wall_s": g0["wall_s"], "stats": g0["stats"]},
        "launches": {r: sv[r]["guarded"]["launches"] for r in ranks},
        "snapshot_ms": {r: sv[r]["guarded"]["snapshot_ms"] for r in ranks},
        "recover_ms": {r: sv[r]["guarded"]["recover_ms"] for r in ranks},
        "lcc_decode_host_ms": g0["lcc_decode_host_ms"],
        "held_bytes": [sv[r]["held_bytes"] for r in ranks], "peak_bytes": [sv[r]["guarded"]["peak_bytes"] for r in ranks],
        "transport": g0["transport"], "seconds": [sv[r]["seconds"] for r in ranks],
        "init_s": [sv[r]["init_s"] for r in ranks], "compare_s": sv[0]["compare_s"],
        "p3": {"p": CM_WIDE_P, "rows_equal_one_program": True,
               "launches": {r: sv[r]["wide"]["launches"] for r in ranks},
               "snapshot_ms": [sv[r]["wide"]["snapshot_ms"] for r in ranks],
               "peak_bytes": [sv[r]["wide"]["peak_bytes"] for r in ranks]}}

    # (c) the launcher: --coded gives the tokens of the same command without it
    ln = results["launcher"]
    check(all(ln[r]["coded"]["tokens"] == ln[r]["plain"]["tokens"] == ln[0]["plain"]["tokens"] for r in ranks),
          f"coded_mesh/launcher: --coded gives other tokens: {ln[0]['coded']['tokens']} {ln[0]['plain']['tokens']}")
    lc = ln[0]["coded"]
    check(lc["stats"]["recoveries"] == 2 and lc["stats"]["injected_faults"] == 2,
          f"coded_mesh/launcher: stats {lc['stats']}")
    check(lc["width"] == mcfg["S"]["launch"],
          f"coded_mesh/launcher: the coded shards are {lc['width']} limbs wide, not {mcfg['S']['launch']}")
    check(any("cli-0" in s for s in lc["printed"]) and not any(ln[r]["coded"]["printed"] for r in ranks if r),
          "coded_mesh/launcher: rank 0 alone must print the sequences")
    lsnaps = lc["stats"]["snapshots"]
    want = count_calls(mcfg["runs"]["launch"])
    for r in ranks:
        got = ln[r]["coded"]["launches"]
        exp = (want[0] * lsnaps, want[1] * lsnaps) if r == 0 else (0, 0)
        check(not on_card or (got["gf_matmul"], got["butterfly_mac"]) == exp,
              f"coded_mesh/launcher: rank {r} launched {got}, expected {exp}")
        add(got)
    launcher_rec = {"argv_coded": CM_LAUNCH_CODED, "max_new": CM_LAUNCH_NEW, "tokens_equal_uncoded": True,
                    "printed": lc["printed"], "stats": lc["stats"], "shard_limbs": lc["width"],
                    "snapshot_ms": lc["snapshot_ms"], "recover_ms": lc["recover_ms"],
                    "seconds": {"plain": ln[0]["plain"]["seconds"], "coded": lc["seconds"]},
                    "peak_bytes": [ln[r]["coded"]["peak_bytes"] for r in ranks],
                    "launches": {r: ln[r]["coded"]["launches"] for r in ranks}}

    # (d) the train guard over the meshed smoke state
    tr = results["train"]
    check(all(tr[r]["losses"] == tr[0]["losses"] and all(math.isfinite(v) for v in tr[r]["losses"]) for r in ranks),
          f"coded_mesh/train: losses {[tr[r]['losses'] for r in ranks]}")
    check(tr[0]["one_process_equal"], "coded_mesh/train: the shards or parity differ from a one-process guard's")
    check(all(tr[r]["blocks_equal"] and tr[r]["recovered_step"] == tr[r]["step"] == CM_TRAIN_STEPS - 1 for r in ranks),
          "coded_mesh/train: fail_and_recover + reshard_state is not bit-exact on every rank")
    check(tr[0]["holds"] and not any(tr[r]["holds"] for r in ranks if r),
          "coded_mesh/train: rank 0 alone must hold the shards")
    raised = [tr[r]["raise"] for r in ranks]
    check(raised[0]["raised"] == "MemoryError: the root's encode, made to raise"
          and all(x["raised"] == "RuntimeError: the coded snapshot failed on rank 0" for x in raised[1:]),
          f"coded_mesh/train: a raise in rank 0's encode was not told to every rank: {[x['raised'] for x in raised]}")
    check(all(x["step"] == x["recovered_step"] == CM_TRAIN_STEPS - 1 and x["recovered_equal"] for x in raised),
          f"coded_mesh/train: after the raise a rank lost the last snapshot or recovered another state: {raised}")
    check(tr[0]["width"] == mcfg["S"]["train"],
          f"coded_mesh/train: shards {tr[0]['width']} limbs wide, not {mcfg['S']['train']}")
    want = count_calls(mcfg["runs"]["train"])
    tsnaps = len(tr[0]["snapshot_ms"])
    for r in ranks:
        got = tr[r]["launches"]
        exp = (want[0] * tsnaps, want[1] * tsnaps) if r == 0 else (0, 0)
        check(not on_card or (got["gf_matmul"], got["butterfly_mac"]) == exp,
              f"coded_mesh/train: rank {r} launched {got}, expected {exp}")
        add(got)
    train_rec = {"argv": ["--smoke", "--coded-every", "1", "--steps", CM_TRAIN_STEPS, "--batch", SMALL_TRAIN_BATCH,
                          "--seq", SMALL_TRAIN_SEQ], "K": CM_TRAIN_K, "lost": CM_TRAIN_LOST, "losses": tr[0]["losses"],
                 "shard_limbs": tr[0]["width"], "one_process_equal": True, "reshard_bit_equal": True,
                 "snapshot_ms": {r: tr[r]["snapshot_ms"] for r in ranks}, "recover_ms": [tr[r]["recover_ms"] for r in ranks],
                 "held_bytes": [tr[r]["held_bytes"] for r in ranks], "peak_bytes": [tr[r]["peak_bytes"] for r in ranks],
                 "seconds": tr[0]["seconds"], "raise_on_root": {"kept_step": raised[0]["step"], "recovered_equal": True,
                                                               "seconds": [x["seconds"] for x in raised]}}

    # (d') the train guard over the meshed full-width state, one layer
    tf = results["train_full"]
    check(all(tf[r]["losses"] == tf[0]["losses"] and all(math.isfinite(v) for v in tf[r]["losses"]) for r in ranks),
          f"coded_mesh/train_full: losses {[tf[r]['losses'] for r in ranks]}")
    check(tf[0]["holds"] and not any(tf[r]["holds"] for r in ranks if r) and tf[0]["width"] == mcfg["S"]["train_full"],
          f"coded_mesh/train_full: rank 0 alone must hold shards of {mcfg['S']['train_full']} limbs")
    check(tf[0]["shards_equal"] and tf[0]["parity_equal"],
          f"coded_mesh/train_full: blocks {tf[0]['blocks_checked']}: shards equal {tf[0]['shards_equal']}, "
          f"parity equal to the plain kernel {tf[0]['parity_equal']}")
    want = count_calls(mcfg["runs"]["train_full"])
    fsnaps = len(tf[0]["snapshot_ms"])
    for r in ranks:
        got = tf[r]["launches"]
        exp = (want[0] * fsnaps, want[1] * fsnaps) if r == 0 else (0, 0)
        check(not on_card or (got["gf_matmul"], got["butterfly_mac"]) == exp,
              f"coded_mesh/train_full: rank {r} launched {got}, expected {exp}")
        add(got)
    full_rec = {"argv": ["--layers", CM_FULL_LAYERS, "--coded-every", "1", "--steps", CM_FULL_STEPS, "--batch",
                         CM_FULL_BATCH, "--seq", CM_FULL_SEQ], "K": CM_TRAIN_K, "losses": tf[0]["losses"],
                "shard_limbs": tf[0]["width"], "blocks": tf[0]["blocks"], "blocks_checked": tf[0]["blocks_checked"],
                "host_bytes": tf[0]["host_bytes"], "snapshot_ms": {r: tf[r]["snapshot_ms"] for r in ranks},
                "rank0_snapshot_memory": tf[0]["snapshot_memory"], "held_bytes": [tf[r]["held_bytes"] for r in ranks],
                "peak_bytes": [tf[r]["peak_bytes"] for r in ranks], "seconds": tf[0]["seconds"]}
    launcher_rec["rank0_snapshot_memory"] = lc["snapshot_memory"]
    check(phase_s <= CM_PHASE_S, f"coded_mesh: the phase took {phase_s:.1f} s, over {CM_PHASE_S} s")
    return counted, {"serve": serve_rec, "launcher": launcher_rec, "train": train_rec, "train_full": full_rec,
                     "launches": counted, "seconds": phase_s}


# ---------------------------------------------------------------------------
# phase 17: the MoE and MLA families on the 2x2 mesh, DeepSeek-V3 at full width
# ---------------------------------------------------------------------------

# phase mla's cut, from 61 to 4 layers, no width cut: the 3 dense prefix
# layers, one MoE layer and MTP, 53.4 GB of bf16 weights whole; on the mesh
# under the decode preset's opt rules the expert leaves split four ways and
# the rest two ways, ~15 GB a rank
MM_ARCH, MM_LAYERS = MLA_ARCH, MLA_LAYERS
MM_MAX_NEW = 16
MM_LAUNCH_NEW = 4  # (d): its tokens are the first of (a)'s for the same prompts
MM_LAUNCH_REQS = (1, 3)  # (d): the trace's requests of 75 and 110 tokens (the launcher's buckets stop at 256)
MM_SMALL = (MLA_ARCH, MOE_ARCH)  # (c): the float32 smoke configs on the mesh against the CPU
MM_SMALL_BATCH = (4, 16)  # (c): one train step's batch and sequence
MM_NORM_RTOL = 1e-5  # (c): the step's global gradient norm against the CPU's (tests/test_torch_train.py's)
MM_PEAK_SUM_MAX = 76 * 10**9  # the ranks' peaks together, at most (the card holds 80 GB)
MM_DRAW_SLACK = 1 << 30  # a rank's draw peaks at most this over its blocks: one float32 slab and its cast
MM_DEADLINE_S = 600  # the whole phase: a rank that has not answered by then fails the run
MM_PHASE_S = 240  # what the phase may take
MM_ENTRY = "CodedServeGuard(mesh=hosts).snapshot, DeepSeek-V3"


def mm_rules(cfg):
    """The rules of (a), (b) and (d): the reference's decode preset under its
    ``opt`` profile (experts over ``data``, ``moe_ff`` and the heads over
    ``model``; DeepSeek-V3 keeps FSDP's ``d_model`` over ``data``), as
    ``launch/serve.py --profile opt`` picks them."""
    return rules_for(cfg, ShapeSpec("cli", "decode", SERVE_POSITIONS, 1), OPT)


def mm_held(model, rules) -> int:
    """Bytes of weights a rank holds under ``rules`` on the 2x2 mesh, from
    the leaves' specs on a mesh made by hand (every split divides)."""
    hand = RankMesh(None, MESH_SHAPE, MESH_AXES, 0, (0, 0), tuple(range(math.prod(MESH_SHAPE))), torch.device("cpu"))
    sizes = dict(zip(MESH_AXES, MESH_SHAPE))
    total = 0
    for t, s in zip(tree.leaves(model.param_specs()), tree.leaves(param_shardings(model, hand, rules))):
        split = math.prod(sizes[a] for e in s.spec if e for a in ((e,) if isinstance(e, str) else e))
        total += t.numel() * t.element_size() // split
    return total


def moe_mesh_config() -> dict:
    """Phase 17's configuration, handed to every rank: DeepSeek-V3 cut to
    MM_LAYERS layers, max_len, buckets and the trace's mix, the rules and
    the bytes a rank holds under them, the guard's shard width ``S`` and the
    kernel calls of one rank-form snapshot (``paths``, for phase 3)."""
    cfg = get(MM_ARCH).replace(n_layers=MM_LAYERS)
    model = build_model(cfg)
    plan = build_lcc(CM_K, R=CM_R)
    S = -(-limb_count(cm_state_spec(model, MM_MAX_NEW)) // CM_K)
    runs = ir_kernel_calls(plan_prepare_shoot(plan.N, plan.p).to_ir(lcc_generator(plan), q=NTT), S, batch=1)
    rules = mm_rules(cfg)
    return {"serve": cfg, "max_len": SERVE_POSITIONS, "buckets": MESH_BUCKETS, "mix": SERVE_MIX, "S": S, "runs": runs,
            "held": mm_held(model, rules), "whole": spec_bytes(model.param_specs()), "launcher_extra": [],
            "small": [smoke_config(a).replace(dtype="float32") for a in MM_SMALL],
            "paths": [{"name": "moe_mesh", "q": NTT, "runs": {MM_ENTRY: runs}}]}


def mm_requests(mcfg: dict) -> list:
    """The serve trace's first CM_REQUESTS requests (426, 75, 239, 110
    tokens), budget MM_MAX_NEW, all arrived."""
    trace = poisson_trace(SERVE_REQUESTS, SERVE_RATE, mix=mcfg["mix"], max_new_tokens=SERVE_MAX_NEW,
                          vocab_size=mcfg["serve"].vocab_size, seed=SEED + 1001)[:CM_REQUESTS]
    return [dataclasses.replace(r, max_new_tokens=MM_MAX_NEW, arrival_s=0.0) for r in trace]


@contextlib.contextmanager
def moe_layer_calls(sink: list):
    """Each ``moe_block`` call while the block runs: its wall ms (the device
    synchronised on both sides) and the collectives it staged."""
    fn = model_layers.moe_block

    def counted(*a, **kw):
        dev = a[1].device
        sync(dev)
        before = sum(staging.staged_calls().values())
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        sync(dev)
        sink.append({"ms": (time.perf_counter() - t0) * 1e3, "staged_calls": sum(staging.staged_calls().values())
                     - before})
        return out

    model_layers.moe_block = counted
    try:
        yield sink
    finally:
        model_layers.moe_block = fn


def mm_serve(rank: int, dev, mcfg: dict) -> dict:
    """(a) and (b) on a rank: DeepSeek-V3 at full width, MM_LAYERS layers,
    each rank drawing only its own blocks from the seed
    (``Model.init(shardings=)``); the engine over the four requests; one
    prefill's and one tick's logits; a tick counted whole and the MoE
    layer's part of it (``CommDebugMode``, staged calls, ms); then the same
    requests under ``CodedServeGuard(K=2, R=2, mesh=hosts)``, host 3 killed
    after tick 8."""
    from torch.distributed.tensor.debug import CommDebugMode

    mesh = make_mesh(MESH_SHAPE, MESH_AXES, device=dev)
    hosts = make_mesh((math.prod(MESH_SHAPE),), ("hosts",), group=dist.new_group(backend="gloo"), device=dev)
    cfg, max_len = mcfg["serve"], mcfg["max_len"]
    model = build_model(cfg)
    rules = mm_rules(cfg)
    ps = param_shardings(model, mesh, rules)
    sync(dev)
    reset_peak(dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), shardings=ps)
    sync(dev)
    out = {"draw_s": time.perf_counter() - t0, "draw_peak_bytes": peak(dev), "held_bytes": local_bytes(params),
           "placed": all(isinstance(t, DTensor) for t in tree.leaves(params))}
    eng = ContinuousEngine(model, params, n_slots=SERVE_SLOTS, max_len=max_len, buckets=mcfg["buckets"],
                           max_new_tokens=MM_MAX_NEW, mesh=mesh, rules=rules, metrics=MetricsRegistry(),
                           tracer=Tracer())
    out["engine_kept_blocks"] = all(a is b for a, b in zip(tree.leaves(eng.params), tree.leaves(params)))
    del params
    reqs = mm_requests(mcfg)
    sync(dev)
    rep = eng.serve(reqs, greedy=True, sync_every=SERVE_SYNC)
    hist = eng._registry().snapshot()
    out["plain"] = {"tokens": tokens_of(rep), "tokens_per_s": rep.tokens_per_s, "wall_s": rep.wall_s,
                    "decode_steps": rep.decode_steps, "ttft_ms": rep.ttft_ms,
                    "tick_ms": hist["serve.decode_chunk_us"]["p50"] / SERVE_SYNC / 1e3,
                    "prefill_ms": {"p50": hist["serve.prefill_us"]["p50"] / 1e3,
                                   "max": hist["serve.prefill_us"]["max"] / 1e3}}
    probe = logits_probe(model, eng.params, reqs[0], max_len, mcfg["buckets"], mesh, rules, reqs[0].prompt[-1])
    dec, step_toks, pos = probe.pop("step")
    cache = probe.pop("cache")
    staging.reset_counts()
    layer_calls: list = []
    sync(dev)
    t = time.perf_counter()
    with CommDebugMode() as cdm, moe_layer_calls(layer_calls):
        dec(eng.params, cache, step_toks, pos)
    sync(dev)
    out["counted_tick"] = {"ms": (time.perf_counter() - t) * 1e3,
                           "collectives": {str(k): int(v) for k, v in cdm.get_comm_counts().items()},
                           "staged_calls": staging.staged_calls(), "staged_bytes": staging.staged_bytes(),
                           "moe_layer": layer_calls}
    del cache
    if rank == 0:
        out["probe"] = probe
    plan = build_lcc(CM_K, R=CM_R)
    guard = CodedServeGuard(K=CM_K, R=CM_R, injector=FaultInjector(kills=CM_KILLS), mesh=hosts, axis="hosts")
    calls: dict = {}
    host_ms: list = []
    sync(dev)
    zero_launches()
    with guard_calls(CodedServeGuard, calls), timed(serve_coded, "lcc_decode", host_ms):
        rep = eng.serve(reqs, greedy=True, sync_every=SERVE_SYNC, guard=guard)
    sync(dev)
    out["guarded"] = {"tokens": tokens_of(rep), "tokens_per_s": rep.tokens_per_s, "wall_s": rep.wall_s,
                      "stats": rep.coded, "alive": sorted(guard.alive), "launches": launch_counts(),
                      "snapshot_ms": calls["snapshot_ms"], "recover_ms": calls.get("recover_ms", []),
                      "lcc_decode_host_ms": host_ms, "width": calls.get("width"), "host": guard._host,
                      "kernels": guard._ranks.kernels, "transport": guard._ranks.transport,
                      "calls": ir_kernel_calls(guard._ranks.ir, mcfg["S"], batch=1), "N": plan.N}
    out["peak_bytes"] = peak(dev)
    del eng
    return out


def mm_small(rank: int, dev, mcfg: dict) -> dict:
    """(c) on a rank: each float32 smoke config on the mesh on the card, its
    weights drawn on the CPU from a seed: the continuous engine over the
    reference's staggered trace, and one train step of ``make_train_step(
    mesh=)`` (rank 0 returns the whole parameters and moments)."""
    mesh = make_mesh(MESH_SHAPE, MESH_AXES, device=dev)
    out = {}
    for i, cfg in enumerate(mcfg["small"]):
        model = build_model(cfg)
        p = tree.map(lambda t: t.to(dev), model.init(torch.Generator().manual_seed(SEED + 1700 + i)))
        srules = rules_for(cfg, ShapeSpec("serve-test", "decode", 32, 4), BASELINE)
        eng = ContinuousEngine(model, p, n_slots=4, max_len=32, buckets=(8, 16), max_new_tokens=8, mesh=mesh,
                               rules=srules, metrics=MetricsRegistry())
        rec = {"tokens": tokens_of(eng.serve(mesh_small_requests(), greedy=True, sync_every=2))}
        B, S = MM_SMALL_BATCH
        trules = rules_for(cfg, ShapeSpec("t", "train", S, B), BASELINE)
        st = init_state(RESUME_OPT, p)
        p0, s0 = place((p, st), (param_shardings(model, mesh, trules), opt_state_shardings(RESUME_OPT, model, mesh,
                                                                                           trules)))
        bsh = batch_shardings(model, mesh, trules)
        b = make_batch(cfg, B, S, seed=SEED + 1710 + i, device=dev)
        np_, ns, met = make_train_step(model, RESUME_OPT, rules=trules, mesh=mesh)(p0, s0,
                                                                                   place(b, {k: bsh[k] for k in b}))
        rec["metrics"] = {k: float(whole(v)) for k, v in met.items()}
        state = tree.map(lambda t: whole(t).cpu(), (np_, ns))  # every rank: the gathers are collective
        if rank == 0:
            rec["state"] = state
        out[cfg.name] = rec
        del eng, p, p0, s0, np_, ns, state
    return out


def mm_launcher(rank: int, dev, mcfg: dict) -> dict:
    """(d) on a rank: ``launch/serve.py --mesh 2x2 --arch deepseek-v3-671b
    --layers 4 --profile opt`` on two of (a)'s prompts, MM_LAUNCH_NEW new
    tokens: the launcher's own sharded draw at full width (rank 0 prints)."""
    reqs = mm_requests(mcfg)
    argv = ["--arch", MM_ARCH, "--mesh", "2x2", "--layers", str(MM_LAYERS), "--max-new", str(MM_LAUNCH_NEW),
            "--max-len", str(mcfg["max_len"]), "--profile", "opt",
            "--prompts", ";".join(",".join(map(str, reqs[i].prompt)) for i in MM_LAUNCH_REQS), *mcfg["launcher_extra"]]
    buf = io.StringIO()
    sync(dev)
    reset_peak(dev)
    with contextlib.redirect_stdout(buf):
        rep = serve_main(argv)
    sync(dev)
    return {"tokens": tokens_of(rep), "printed": buf.getvalue().splitlines(), "peak_bytes": peak(dev)}


def moe_mesh_worker(rank: int, world: int, init: str, mcfg: dict, go, out, device_type: str):
    """A rank of phase ``moe_mesh``: joins the world (the port's staging
    backend on the card, gloo on the CPU), says it is ready, waits for the
    parent's go and runs (a)-(d), sending each part's result. Any error is
    sent to the parent, which fails the run."""
    try:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # every rank lives on this host
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))  # the ranks share the host's cores
        dev = torch.device("cpu")
        backend = "gloo"
        if device_type == "cuda":
            torch.cuda.set_device(0)
            dev = torch.device("cuda", 0)
            staging.register()
            backend = staging.BACKEND
        dist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
        torch.zeros(1, device=dev)
        out.put(("ready", rank, None, None))
        if not go.wait(MM_DEADLINE_S):
            raise TimeoutError("the parent never said go")
        for part, fn in (("serve", mm_serve), ("small", mm_small), ("launcher", mm_launcher)):
            t0 = time.perf_counter()
            res = fn(rank, dev, mcfg)
            res["seconds"] = time.perf_counter() - t0
            out.put(("ok", rank, part, res))
            if dev.type == "cuda":
                gc.collect()
                torch.cuda.empty_cache()
        dist.destroy_process_group()
        out.put(("done", rank, None, None))
    except BaseException:  # reported to the parent, which fails the run
        out.put(("error", rank, None, traceback.format_exc()))


def mm_reference(dev, mcfg: dict) -> dict:
    """The parent's side: the same seed's model in one process on the card
    (the whole 53.4 GB), the logits of one prefill and one tick, then the
    card freed; and each float32 smoke config's engine tokens and one train
    step on the CPU."""
    cfg, max_len = mcfg["serve"], mcfg["max_len"]
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    req = mm_requests(mcfg)[0]
    probe = logits_probe(model, params, req, max_len, mcfg["buckets"], None, None, req.prompt[-1])
    ref = {"probe": {k: probe[k] for k in ("prefill", "tick")}}
    del params, probe
    if dev.type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
    cpu = torch.device("cpu")
    for i, scfg in enumerate(mcfg["small"]):
        small = build_model(scfg)
        p = small.init(torch.Generator().manual_seed(SEED + 1700 + i))
        eng = ContinuousEngine(small, p, n_slots=4, max_len=32, buckets=(8, 16), max_new_tokens=8,
                               metrics=MetricsRegistry())
        rec = {"tokens": tokens_of(eng.serve(mesh_small_requests(), greedy=True, sync_every=2))}
        B, S = MM_SMALL_BATCH
        trules = rules_for(scfg, ShapeSpec("t", "train", S, B), BASELINE)
        b = make_batch(scfg, B, S, seed=SEED + 1710 + i, device=cpu)
        np_, ns, met = make_train_step(small, RESUME_OPT, rules=trules)(p, init_state(RESUME_OPT, p), b)
        rec["metrics"] = {k: float(v) for k, v in met.items()}
        rec["state"] = (np_, ns)
        ref[scfg.name] = rec
    return ref


def moe_mesh_phase(mcfg: dict, dev) -> tuple[dict, dict]:
    """Phase ``moe_mesh``: the parent computes the one-process logits on
    the card and frees it, then one spawned world of four ranks runs
    (a)-(d); every check is the parent's. Returns (the launches of the
    guard's kernels, summed over the ranks, the phase's record)."""
    import multiprocessing as mp

    t0 = time.perf_counter()
    world = math.prod(MESH_SHAPE)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        check(held < MOE_HELD_MAX, f"moe_mesh: earlier phases still hold {held} bytes of the card")
    ctx = mp.get_context("spawn")  # the parent has initialised CUDA: no fork
    tmp = tempfile.TemporaryDirectory()
    go, out = ctx.Event(), ctx.Queue()
    init = "file://" + os.path.join(tmp.name, "store")
    procs = [ctx.Process(target=moe_mesh_worker, args=(r, world, init, mcfg, go, out, dev.type), daemon=True)
             for r in range(world)]
    results: dict = {}
    try:
        for p in procs:
            p.start()
        t_ref = time.perf_counter()
        ref = mm_reference(dev, mcfg)
        ref_s = time.perf_counter() - t_ref
        go.set()
        want, got, deadline = world * 5, 0, time.monotonic() + MM_DEADLINE_S  # ready, 3 parts, done
        while got < want:
            try:
                status, rank, part, value = out.get(timeout=5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                check(not dead, f"moe_mesh: rank(s) {dead} died (exit codes {[procs[r].exitcode for r in dead]})")
                check(time.monotonic() < deadline, f"moe_mesh: the ranks did not finish within {MM_DEADLINE_S} s")
                continue
            check(status != "error", f"moe_mesh: rank {rank} raised:\n{value}")
            got += 1
            if status == "ok":
                results.setdefault(part, {})[rank] = value
                if rank == 0:  # progress, on the error stream
                    print(f"chip_smoke: moe_mesh/{part} done on rank 0 in {value['seconds']:.1f} s, "
                          f"{time.perf_counter() - t0:.1f} s into the phase: "
                          f"{json.dumps(untokened(value), default=str)[:3000]}",
                          file=sys.stderr, flush=True)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(30)
        tmp.cleanup()
    phase_s = time.perf_counter() - t0
    ranks = range(world)
    on_card = dev.type == "cuda"

    # (a) serving at full width: every rank alike, the logits near one process's, each rank its own blocks
    sv = results["serve"]
    toks = sv[0]["plain"]["tokens"]
    check(all(sv[r]["plain"]["tokens"] == toks for r in ranks), "moe_mesh/serve: the ranks' tokens differ")
    check(all(sv[r]["placed"] and sv[r]["engine_kept_blocks"] for r in ranks),
          "moe_mesh/serve: the sharded draw did not give the engine DTensors it kept")
    check(all(sv[r]["held_bytes"] == mcfg["held"] for r in ranks),
          f"moe_mesh/serve: ranks hold {[sv[r]['held_bytes'] for r in ranks]} bytes, the specs say {mcfg['held']}")
    check(all(sv[r]["draw_peak_bytes"] <= mcfg["held"] + MM_DRAW_SLACK for r in ranks),
          f"moe_mesh/serve: a rank's draw peaked at {[sv[r]['draw_peak_bytes'] for r in ranks]} bytes")
    peaks = [sv[r]["peak_bytes"] for r in ranks]
    check(not on_card or sum(peaks) <= MM_PEAK_SUM_MAX, f"moe_mesh/serve: the ranks' peaks {peaks} pass "
                                                        f"{MM_PEAK_SUM_MAX} bytes together")
    pr, rp = sv[0]["probe"], ref["probe"]
    lerr = {k: logits_err(pr[k], rp[k]) for k in ("prefill", "tick")}
    check(all(v["finite"] and v["rms_of_rms"] <= REFEED_RMS_TOL and v["max_of_max"] <= REFEED_MAX_TOL
              for v in lerr.values()), f"moe_mesh/serve: the full-width logits differ from one process's: {lerr}")
    reqs = mm_requests(mcfg)
    check(all(len(toks[r.id]) == len(r.prompt) + MM_MAX_NEW and all(0 <= t < mcfg["serve"].vocab_size
                                                                    for t in toks[r.id]) for r in reqs),
          "moe_mesh/serve: a request's tokens are not its prompt and its budget in the vocabulary")
    ct = sv[0]["counted_tick"]

    # (b) the guard on the meshed latent cache: the tokens of (a) on every rank
    g0 = sv[0]["guarded"]
    check(all(sv[r]["guarded"]["tokens"] == toks for r in ranks),
          "moe_mesh/serve: the guarded tokens differ from the unguarded run's")
    check(all(sv[r]["guarded"]["stats"]["recoveries"] == 1 and sv[r]["guarded"]["alive"] == [0, 1, 2]
              and sv[r]["guarded"]["host"] == r for r in ranks),
          f"moe_mesh/serve: guard stats {[sv[r]['guarded']['stats'] for r in ranks]}")
    check(g0["width"] == mcfg["S"], f"moe_mesh/serve: rows {g0['width']} limbs wide, not phase 3's {mcfg['S']}")
    counted = {"gf_matmul": 0, "butterfly_mac": 0}
    snaps = g0["stats"]["snapshots"]
    want = count_calls(mcfg["runs"])
    for r in ranks:
        gr = sv[r]["guarded"]
        check(gr["calls"] == mcfg["runs"], f"moe_mesh/serve: rank {r} runs other kernels than phase 3 held")
        check(not on_card or (gr["kernels"] == "cuda" and (gr["launches"]["gf_matmul"], gr["launches"]["butterfly_mac"])
                              == (want[0] * snaps, want[1] * snaps)),
              f"moe_mesh/serve: rank {r} launched {gr['launches']}, expected {want} a snapshot x {snaps}")
        for k in counted:
            counted[k] += gr["launches"][k]
    check(not on_card or counted["gf_matmul"] > 0, "moe_mesh: the guard never launched gf_matmul")

    # (c) the float32 smoke configs on the mesh on the card against the CPU
    sm = results["small"]
    small_rec = {}
    for scfg in mcfg["small"]:
        name = scfg.name
        check(all(sm[r][name]["tokens"] == ref[name]["tokens"] for r in ranks),
              f"moe_mesh/small: {name}'s tokens on the mesh differ from the CPU's")
        (gp, gs), (cp, cs) = sm[0][name]["state"], ref[name]["state"]
        worst, tol = small_errors(gp, gs, [sm[0][name]["metrics"]["loss"]], cp, cs, [ref[name]["metrics"]["loss"]],
                                  [ref[name]["metrics"]["lr"]])
        norm_mesh, norm_cpu = sm[0][name]["metrics"]["grad_norm"], ref[name]["metrics"]["grad_norm"]
        gn = abs(norm_mesh - norm_cpu) / norm_cpu
        check(all(worst[k] <= tol[k] for k in worst) and gn <= MM_NORM_RTOL,
              f"moe_mesh/small: {name}'s train step on the mesh and the CPU's differ: {worst}, norm {gn}")
        small_rec[name] = {"tokens_equal_cpu": True, "max_err": worst, "tolerance": tol, "grad_norm_rel_err": gn,
                           "metrics": sm[0][name]["metrics"]}

    # (d) the launcher's own sharded draw: the first tokens of (a) for its prompts
    ln = results["launcher"]
    cut = {f"cli-{j}": toks[reqs[i].id][:len(reqs[i].prompt) + MM_LAUNCH_NEW] for j, i in enumerate(MM_LAUNCH_REQS)}
    check(all(ln[r]["tokens"] == cut for r in ranks),
          f"moe_mesh/launcher: launch/serve.py --mesh 2x2 gives other tokens than (a)'s engine")
    check(any("cli-0" in line for line in ln[0]["printed"]) and not any(ln[r]["printed"] for r in ranks if r),
          "moe_mesh/launcher: rank 0 alone must print the sequences")
    check(phase_s <= MM_PHASE_S, f"moe_mesh: the phase took {phase_s:.1f} s, over {MM_PHASE_S} s")
    p0 = sv[0]["plain"]
    record = {
        "arch": MM_ARCH, "layers": f"{MM_LAYERS} of {get(MM_ARCH).n_layers} (3 dense prefix, 1 MoE) + MTP",
        "mesh": dict(zip(MESH_AXES, MESH_SHAPE)), "rules": "decode preset, opt profile",
        "whole_bytes": mcfg["whole"], "held_bytes_by_specs": mcfg["held"],
        "held_bytes": [sv[r]["held_bytes"] for r in ranks], "draw_s": [sv[r]["draw_s"] for r in ranks],
        "draw_peak_bytes": [sv[r]["draw_peak_bytes"] for r in ranks], "peak_bytes": peaks,
        "requests": [len(r.prompt) for r in reqs], "max_new": MM_MAX_NEW, "slots": SERVE_SLOTS,
        "max_len": mcfg["max_len"], "tokens_equal_across_ranks": True, "logits_err": lerr,
        "logits_tolerance": {"rms_of_rms": REFEED_RMS_TOL, "max_of_max": REFEED_MAX_TOL},
        "tokens_per_s": p0["tokens_per_s"], "wall_s": p0["wall_s"], "decode_steps": p0["decode_steps"],
        "ttft_ms": p0["ttft_ms"], "tick_ms": [sv[r]["plain"]["tick_ms"] for r in ranks], "prefill_ms": p0["prefill_ms"],
        "counted_tick": ct,
        "guarded": {"K": CM_K, "R": CM_R, "kills": CM_KILLS, "tokens_equal_unguarded_every_rank": True,
                    "tokens_per_s": g0["tokens_per_s"], "stats": g0["stats"], "row_limbs": g0["width"],
                    "snapshot_ms": {r: sv[r]["guarded"]["snapshot_ms"] for r in ranks},
                    "recover_ms": {r: sv[r]["guarded"]["recover_ms"] for r in ranks},
                    "lcc_decode_host_ms": g0["lcc_decode_host_ms"], "transport": g0["transport"],
                    "launches": {r: sv[r]["guarded"]["launches"] for r in ranks}},
        "small": small_rec,
        "launcher": {"tokens_equal_engine": True, "max_new": MM_LAUNCH_NEW, "printed": ln[0]["printed"],
                     "peak_bytes": [ln[r]["peak_bytes"] for r in ranks], "seconds": [ln[r]["seconds"] for r in ranks]},
        "seconds_by_part": {part: [results[part][r]["seconds"] for r in ranks] for part in results},
        "launches": counted, "reference_s": ref_s, "seconds": phase_s}
    return counted, record


# ---------------------------------------------------------------------------
# phase 18: the SSM, encoder-decoder and VLM families on the 2x2 mesh at full width
# ---------------------------------------------------------------------------

# every width kept, the depths of phases 12 and 13: RWKV6-3B 4 of its 32
# layers (1.3 GB; 8 until the whole script took 1,156.5 s on a slow H100 host),
# Jamba one period of 8 (26.6 GB), Whisper-base whole, InternVL2-26B 6 of 48
# (7.0 GB)
FM_MODELS = ((RWKV_ARCH, RWKV_LAYERS), (JAMBA_ARCH, JAMBA_LAYERS), (WHISPER_ARCH, None), (VLM_ARCH, VLM_LAYERS))
FM_RECURRENT = (RWKV_ARCH, JAMBA_ARCH)
# (a): the first FIXED_PROMPTS prompts of the serve trace (phases 12-13's), cut to these lengths so that the
# refeed (the longest prompt plus FM_MAX_NEW ticks, a tick a few hundred ms on the mesh) fits the phase's time
# (16, 9, 12 and 7 tokens until that run)
FM_PROMPT_LENS = (10, 6, 8, 5)
FM_MAX_NEW, FM_MAX_LEN = 8, 64
FM_PROBE_TICKS = 4  # (a): one tick's logits: the fourth refeed tick of the prompts' first tokens
FM_FRAMES_SEED = SEED + 1801  # (a): the probe prompt's stub frames or patches
# (b): the snapshot mid-prompt (every prompt is longer); host FM_KILL_HOST dies, FM_LOST_TICKS ticks lost; the refeed
# resumes until the shortest prompt's row has all its new tokens (as phase 12's does)
FM_SNAPSHOT_TICK, FM_LOST_TICKS = 4, 2
FM_KILL_HOST = 3
FM_LAUNCH_NEW = 4  # (d): its tokens are the first of (a)'s for the same prompts
FM_SMALL_BATCH = (4, 16)  # (c): one train step's batch and sequence (patches included)
FM_TRAIN_ARGV = ["--smoke", "--mesh", "2x2", "--steps", "2", "--batch", "4", "--seq", "16", "--coded-every", "1"]
# (c): the train launcher's runs, the families whose train state the coded guard covers nowhere else on the card
# (the recurrent ones' decode state is (b)'s; all four ran until that run)
FM_TRAIN_ARCHS = (WHISPER_ARCH, VLM_ARCH)
FM_TRAIN_K = 8  # (c): the train launcher's --coded-k default
FM_PEAK_SUM_MAX = 70 * 10**9  # the ranks' peaks together, at most (the card holds 80 GB)
# (a): the probe's logits against one process's within phase 7's bf16 tolerances (REFEED_RMS_TOL, REFEED_MAX_TOL),
# unless the one-process bf16 run routes a token otherwise than the same weights in float32 do (a router near-tie:
# Jamba's tick, 5 of its 20 router calls, and the bf16 tick then departs from float32's by 5.4 % rms); and always
# within the larger of those tolerances and FM_EXACT_SLACK x the one-process bf16 run's distance of the float32 run's
# logits, the exact answer of the same weights: the mesh no less accurate than one process
FM_EXACT_SLACK = 1.25
FM_DEADLINE_S = 600  # the whole phase: a rank that has not answered by then fails the run
FM_PHASE_S = 240  # what the phase may take (it aims at 150 s)
FM_ENTRY = "CodedServeGuard(mesh=hosts).snapshot, {arch}"
FM_TRAIN_ENTRY = "launch/train.py --mesh 2x2 --smoke --coded-every 1, {arch}"


def fm_rules(cfg):
    """The rules of (a), (b) and (d): the reference's decode preset under its
    ``opt`` profile, as ``launch/serve.py --profile opt`` picks them."""
    return rules_for(cfg, ShapeSpec("cli", "decode", FM_MAX_LEN, 1), OPT)


def fm_prompts(vocab: int) -> list:
    return [p[:n] for p, n in zip(ssm_prompts(vocab), FM_PROMPT_LENS)]


def fm_small(arch: str):
    """(c)'s float32 smoke config (Jamba at one period of 8 layers, its
    Mamba, Mamba-MoE and attention layers)."""
    cfg = smoke_config(arch).replace(dtype="float32")
    return cfg.replace(n_layers=8) if arch == JAMBA_ARCH else cfg


def fm_state_spec(model, prompts) -> tuple:
    """(cache, state) of (b)'s guarded refeed, as meta tensors."""
    total = max(map(len, prompts)) + FM_MAX_NEW
    return (model.init_cache(len(prompts), FM_MAX_LEN, device="meta"),
            {"tokens": meta((len(prompts), total), torch.int32), "pos": meta((), torch.int32)})


def families_mesh_config() -> dict:
    """Phase 18's configuration, handed to every rank: each model cut in
    depth, its prompts, the bytes a rank holds under (a)'s rules, the
    rank-form guard's shard width and kernel calls on the recurrent states
    and the train launcher's guard on each smoke state (``paths``, for
    phase 3)."""
    plan, tplan = build_lcc(CM_K, R=CM_R), build_parity_plan(FM_TRAIN_K)
    models, runs, truns = {}, {}, {}
    for arch, layers in FM_MODELS:
        cfg = get(arch) if layers is None else get(arch).replace(n_layers=layers)
        model = build_model(cfg)
        prompts = fm_prompts(cfg.vocab_size)
        models[arch] = {"cfg": cfg, "prompts": prompts, "held": mm_held(model, fm_rules(cfg)),
                        "whole": spec_bytes(model.param_specs())}
        if arch in FM_RECURRENT:
            S = -(-limb_count(fm_state_spec(model, prompts)) // CM_K)
            models[arch]["S"] = S
            runs[FM_ENTRY.format(arch=arch)] = ir_kernel_calls(
                plan_prepare_shoot(plan.N, plan.p).to_ir(lcc_generator(plan), q=NTT), S, batch=1)
        if arch in FM_TRAIN_ARCHS:
            small = build_model(smoke_config(arch))
            ocfg = OptConfig(total_steps=2)
            St = -(-limb_count({"params": small.param_specs(), "opt": state_specs(ocfg, small.param_specs())})
                   // FM_TRAIN_K)
            truns[FM_TRAIN_ENTRY.format(arch=arch)] = in_blocks(
                lambda w: [("gf_matmul", (FM_TRAIN_K, tplan.ps_plan.n, tplan.ps_plan.m, w))], St, FM_TRAIN_K)
    return {"models": models, "launcher_extra": [], "train_extra": [], "small": [fm_small(a) for a, _ in FM_MODELS],
            "runs": runs, "train_runs": truns,
            "paths": [{"name": "families_mesh", "q": NTT, "runs": runs},
                      {"name": "families_mesh", "q": M31, "runs": truns}]}


def fm_probe_batch(cfg, prompt, dev) -> dict:
    """(a)'s prompt for one prefill, with the stub frontend's frames or
    patches for it (seeded, bf16)."""
    b = {"tokens": torch.tensor([prompt], dtype=torch.int32, device=dev)}
    rng = np.random.default_rng(FM_FRAMES_SEED)
    n = cfg.encdec.n_frames if cfg.encdec else cfg.vlm.n_patches if cfg.vlm else 0
    if n:
        x = torch.from_numpy((rng.normal(size=(1, n, cfg.d_model)) * 0.02).astype(np.float32))
        b["frames" if cfg.encdec else "patches"] = x.to(dev).to(torch.bfloat16)
    return b


def fm_probe(model, params, prompts, dev, mesh, rules) -> dict:
    """One prompt's logits (a prefill of prompt 0, the last position) and
    one tick's (the FM_PROBE_TICKS-th refeed tick of every prompt's first
    tokens, from a zero cache), both whole (float32 numpy); both sides are
    fed the same tokens. Returns them with the tick's step, cache and
    inputs, for the counted tick."""
    from repro_torch.serve.engine import _init_cache

    cfg = model.cfg
    V = cfg.vocab_size
    lg = make_prefill_step(model, rules=rules, mesh=mesh)(params, fm_probe_batch(cfg, prompts[0], dev))
    prefill = whole(lg)[0, -1, :V].float().cpu().numpy()
    B = len(prompts)
    cache = _init_cache(model, B, FM_MAX_LEN, dev, mesh, rules)
    dec = make_decode_step(model, rules, mesh=mesh)
    toks = torch.tensor([p[:FM_PROBE_TICKS] for p in prompts], dtype=torch.int32, device=dev)
    for t in range(FM_PROBE_TICKS):
        pos = torch.full((B,), t, dtype=torch.int32, device=dev)
        lg, cache = dec(params, cache, toks[:, t:t + 1], pos)
    return {"prefill": prefill, "tick": whole(lg)[:, 0, :V].float().cpu().numpy(),
            "step": (dec, cache, toks[:, -1:], pos)}


def fm_guard(rank: int, dev, model, params, prompts, want: list, mesh, hosts, rules, S: int) -> dict:
    """(b) on a rank: the refeed of (a)'s prompts through the meshed decode
    step; at FM_SNAPSHOT_TICK the recurrent cache and ``{"tokens", "pos"}``
    under ``CodedServeGuard(K=2, R=2, mesh=hosts)``; FM_LOST_TICKS more
    ticks, then host FM_KILL_HOST dies: ``poll`` and ``recover``. The
    recovery equals the snapshot's bytes (on rank 0, which gathered them);
    the refeed resumed from it, placed back on the mesh until the shortest
    prompt's row is complete, gives (a)'s tokens in every column written by
    then."""
    from repro_torch.serve.engine import _init_cache

    V = model.cfg.vocab_size
    total = max(map(len, prompts)) + FM_MAX_NEW
    toks = torch.zeros((len(prompts), total), dtype=torch.int32)
    for b, p in enumerate(prompts):
        toks[b, :len(p)] = torch.tensor(p, dtype=torch.int32)
    toks = toks.to(dev)
    plen = torch.tensor([len(p) for p in prompts], device=dev)
    step = make_decode_step(model, rules, mesh=mesh)
    T = FM_SNAPSHOT_TICK
    cache = refeed(step, params, _init_cache(model, len(prompts), FM_MAX_LEN, dev, mesh, rules), toks, plen, 0, T, V)
    state = {"tokens": toks, "pos": torch.tensor(T, dtype=torch.int32, device=dev)}
    held = gather_state((cache, state), keep=rank == 0)
    held = None if held is None else tree.map(torch.clone, held)
    guard = CodedServeGuard(K=CM_K, R=CM_R, injector=FaultInjector(kills=((T, FM_KILL_HOST),)), mesh=hosts,
                            axis="hosts")
    calls: dict = {}
    sync(dev)
    zero_launches()
    with guard_calls(CodedServeGuard, calls):
        guard.snapshot(cache, state, tick=T)
        sync(dev)
        launches_snap = launch_counts()
        cache = refeed(step, params, cache, toks, plen, T, T + FM_LOST_TICKS, V)
        dead = guard.poll(T + FM_LOST_TICKS)
        cache_b, state_b = guard.recover(dead)
    bit_exact = held is None or same_bits((cache_b, state_b), held)
    cache_b = place(cache_b, cache_shardings(model, mesh, rules, cache_b))
    toks_b = state_b["tokens"].to(dev)
    stop = min(map(len, prompts)) + FM_MAX_NEW - 1  # the shortest prompt's last token is written at tick stop - 1
    refeed(step, params, cache_b, toks_b, plen, int(state_b["pos"]), stop, V)
    rows = toks_b.cpu().numpy()
    return {"dead": dead, "alive": sorted(guard.alive), "host": guard._host, "bit_exact": bit_exact,
            "resumed_to_tick": stop,
            "resumed_equal": [rows[b, :stop + 1].tolist() for b in range(len(want))] == [w[:stop + 1] for w in want],
            "launches": launches_snap, "snapshot_ms": calls["snapshot_ms"], "recover_ms": calls.get("recover_ms", []),
            "width": calls.get("width"), "kernels": guard._ranks.kernels, "transport": guard._ranks.transport,
            "calls": ir_kernel_calls(guard._ranks.ir, S, batch=1)}


def fm_serve(rank: int, dev, fcfg: dict, arch: str, mesh, hosts) -> dict:
    """(a) and (b) on a rank for one model: each rank draws only its own
    blocks from the seed (``Model.init(shardings=)``); the fixed engine over
    the prompts, greedy; one prompt's and one tick's logits; a tick counted
    (``CommDebugMode``, staged calls and bytes, ms); for a recurrent model
    (b)."""
    from torch.distributed.tensor.debug import CommDebugMode

    m = fcfg["models"][arch]
    cfg, prompts = m["cfg"], m["prompts"]
    model = build_model(cfg)
    rules = fm_rules(cfg)
    ps = param_shardings(model, mesh, rules)
    sync(dev)
    reset_peak(dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), shardings=ps)
    sync(dev)
    out = {"draw_s": time.perf_counter() - t0, "draw_peak_bytes": peak(dev), "held_bytes": local_bytes(params),
           "placed": all(isinstance(t, DTensor) for t in tree.leaves(params))}
    reg = MetricsRegistry()
    eng = Engine(model, params, max_len=FM_MAX_LEN, rules=rules, mesh=mesh, metrics=reg)
    out["engine_kept_blocks"] = all(a is b for a, b in zip(tree.leaves(eng.params), tree.leaves(params)))
    sync(dev)
    t0 = time.perf_counter()
    res = eng.generate(prompts, max_new_tokens=FM_MAX_NEW)
    sync(dev)
    wall = time.perf_counter() - t0
    toks = [res.tokens[b][: res.lengths[b]].tolist() for b in range(len(prompts))]
    out["plain"] = {"tokens": toks, "wall_s": wall, "steps": res.steps, "tick_ms": wall / res.steps * 1e3,
                    "tokens_per_s": reg.snapshot()["serve.tokens_per_s"]["value"]}
    probe = fm_probe(model, params, prompts, dev, mesh, rules)
    dec, cache, step_toks, pos = probe.pop("step")
    staging.reset_counts()
    sync(dev)
    t = time.perf_counter()
    with CommDebugMode() as cdm:
        dec(params, cache, step_toks, pos)
    sync(dev)
    out["counted_tick"] = {"ms": (time.perf_counter() - t) * 1e3,
                           "collectives": {str(k): int(v) for k, v in cdm.get_comm_counts().items()},
                           "staged_calls": staging.staged_calls(), "staged_bytes": staging.staged_bytes()}
    del cache
    if rank == 0:
        out["probe"] = probe
    if arch in FM_RECURRENT:
        out["guarded"] = fm_guard(rank, dev, model, params, prompts, toks, mesh, hosts, rules, m["S"])
    out["peak_bytes"] = peak(dev)
    del eng, params
    return out


def fm_small_run(rank: int, dev, fcfg: dict, mesh) -> dict:
    """(c) on a rank: each float32 smoke config on the mesh on the card, its
    weights drawn on the CPU from a seed: the fixed engine's greedy tokens
    and one train step of ``make_train_step(mesh=)`` (rank 0 returns the
    whole parameters and moments); then ``launch/train.py --mesh 2x2
    --smoke --coded-every 1`` of each of FM_TRAIN_ARCHS, its guard's launches
    counted."""
    out = {}
    for i, cfg in enumerate(fcfg["small"]):
        model = build_model(cfg)
        p = tree.map(lambda t: t.to(dev), model.init(torch.Generator().manual_seed(SEED + 1800 + i)))
        srules = rules_for(cfg, ShapeSpec("serve-test", "decode", 32, 4), BASELINE)
        res = Engine(model, p, max_len=32, rules=srules, mesh=mesh, metrics=MetricsRegistry()).generate(
            [list(r.prompt) for r in mesh_small_requests()[:4]], max_new_tokens=6)
        rec = {"tokens": res.tokens.tolist()}
        B, S = FM_SMALL_BATCH
        trules = rules_for(cfg, ShapeSpec("t", "train", S, B), BASELINE)
        st = init_state(RESUME_OPT, p)
        p0, s0 = place((p, st), (param_shardings(model, mesh, trules),
                                 opt_state_shardings(RESUME_OPT, model, mesh, trules)))
        bsh = batch_shardings(model, mesh, trules)
        b = make_batch(cfg, B, S, seed=SEED + 1810 + i, device=dev)
        np_, ns, met = make_train_step(model, RESUME_OPT, rules=trules, mesh=mesh)(p0, s0,
                                                                                   place(b, {k: bsh[k] for k in b}))
        rec["metrics"] = {k: float(whole(v)) for k, v in met.items()}
        state = tree.map(lambda t: whole(t).cpu(), (np_, ns))  # every rank: the gathers are collective
        if rank == 0:
            rec["state"] = state
        out[cfg.name] = rec
        del p, p0, s0, np_, ns, state
    launcher = {}
    for arch in FM_TRAIN_ARCHS:
        sync(dev)
        zero_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            run = train_main(["--arch", arch, *FM_TRAIN_ARGV, *fcfg["train_extra"]])
        sync(dev)
        g = run["guard"]
        rec = {"losses": [h["loss"] for h in run["history"]], "step": g.step, "held": g._shards is not None,
               "placed": all(isinstance(t, DTensor) for t in tree.leaves(run["state"])), "launches": launch_counts()}
        one = gather_state(run["state"], keep=rank == 0)
        if rank == 0:
            og = CodedStateGuard(K=FM_TRAIN_K, device="cpu")
            og.snapshot(tree.map(lambda t: t.cpu(), one), g.step)
            rec["one_process_equal"] = np.array_equal(og._shards, g._shards) and np.array_equal(og._parity, g._parity)
        launcher[arch] = rec
        del run, one
    out["train_launcher"] = launcher
    return out


def fm_launcher(rank: int, dev, fcfg: dict) -> dict:
    """(d) on a rank: ``launch/serve.py --mesh 2x2 --arch whisper-base
    --profile opt`` on (a)'s prompts, FM_LAUNCH_NEW new tokens: the
    launcher's own sharded draw and its fixed-engine fall-back (rank 0
    prints)."""
    m = fcfg["models"][WHISPER_ARCH]
    argv = ["--arch", WHISPER_ARCH, "--mesh", "2x2", "--max-new", str(FM_LAUNCH_NEW), "--max-len", str(FM_MAX_LEN),
            "--profile", "opt", "--prompts", ";".join(",".join(map(str, p)) for p in m["prompts"]),
            *fcfg["launcher_extra"]]
    buf = io.StringIO()
    sync(dev)
    reset_peak(dev)
    with contextlib.redirect_stdout(buf):
        res = serve_main(argv)
    sync(dev)
    return {"tokens": [res.tokens[b][: res.lengths[b]].tolist() for b in range(len(m["prompts"]))],
            "printed": buf.getvalue().splitlines(), "peak_bytes": peak(dev)}


def families_mesh_worker(rank: int, world: int, init: str, fcfg: dict, go, out, device_type: str):
    """A rank of phase ``families_mesh``: joins the world (the port's staging
    backend on the card, gloo on the CPU), says it is ready, waits for the
    parent's go and runs (a)-(b) model by model, then (c) and (d), sending
    each part's result. Any error is sent to the parent, which fails the
    run."""
    try:
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # every rank lives on this host
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))  # the ranks share the host's cores
        dev = torch.device("cpu")
        backend = "gloo"
        if device_type == "cuda":
            torch.cuda.set_device(0)
            dev = torch.device("cuda", 0)
            staging.register()
            backend = staging.BACKEND
        dist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
        torch.zeros(1, device=dev)
        out.put(("ready", rank, None, None))
        if not go.wait(FM_DEADLINE_S):
            raise TimeoutError("the parent never said go")
        mesh = make_mesh(MESH_SHAPE, MESH_AXES, device=dev)
        hosts = make_mesh((math.prod(MESH_SHAPE),), ("hosts",), group=dist.new_group(backend="gloo"), device=dev)
        parts = [(arch, lambda a=arch: fm_serve(rank, dev, fcfg, a, mesh, hosts)) for arch, _ in FM_MODELS]
        parts += [("small", lambda: fm_small_run(rank, dev, fcfg, mesh)), ("launcher", lambda: fm_launcher(rank, dev, fcfg))]
        for part, fn in parts:
            t0 = time.perf_counter()
            res = fn()
            res["seconds"] = time.perf_counter() - t0
            out.put(("ok", rank, part, res))
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        dist.destroy_process_group()
        out.put(("done", rank, None, None))
    except BaseException:  # reported to the parent, which fails the run
        out.put(("error", rank, None, traceback.format_exc()))


@contextlib.contextmanager
def routes(sink: list):
    """The expert indices of every ``moe_route`` call while the block runs."""
    fn = model_layers.moe_route

    def route(router, xt, cfg):
        out = fn(router, xt, cfg)
        sink.append(out[2].cpu().tolist())
        return out

    model_layers.moe_route = route
    try:
        yield sink
    finally:
        model_layers.moe_route = fn


def fm_reference(dev, fcfg: dict) -> dict:
    """The parent's side: each model in one process on the card, drawn from
    the same seed, the logits of (a)'s probe and its routing, in bf16 and in
    float32 (the bf16 model's weights upcast: the exact answer they give),
    the card freed after each; and each float32 smoke config's engine tokens
    and one train step on the CPU."""
    ref = {}
    for arch, _ in FM_MODELS:
        m = fcfg["models"][arch]
        ref[arch] = {}
        bf16_specs = build_model(m["cfg"]).param_specs()
        for dtype in ("bfloat16", "float32"):
            model = build_model(m["cfg"].replace(dtype=dtype))
            params = model.init(torch.Generator(device=dev).manual_seed(SEED))
            if dtype == "float32":  # round what the bf16 model holds in bf16: its weights, exactly
                with torch.no_grad():
                    for t, spec in zip(tree.leaves(params), tree.leaves(bf16_specs)):
                        if spec.dtype == torch.bfloat16:
                            t.copy_(t.to(torch.bfloat16))
            with routes([]) as sink:
                probe = fm_probe(model, params, m["prompts"], dev, None, None)
            ref[arch][dtype] = {"prefill": probe["prefill"], "tick": probe["tick"], "routes": sink}
            del params, probe
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    cpu = torch.device("cpu")
    for i, scfg in enumerate(fcfg["small"]):
        small = build_model(scfg)
        p = small.init(torch.Generator().manual_seed(SEED + 1800 + i))
        res = Engine(small, p, max_len=32, metrics=MetricsRegistry()).generate(
            [list(r.prompt) for r in mesh_small_requests()[:4]], max_new_tokens=6)
        rec = {"tokens": res.tokens.tolist()}
        B, S = FM_SMALL_BATCH
        trules = rules_for(scfg, ShapeSpec("t", "train", S, B), BASELINE)
        b = make_batch(scfg, B, S, seed=SEED + 1810 + i, device=cpu)
        np_, ns, met = make_train_step(small, RESUME_OPT, rules=trules)(p, init_state(RESUME_OPT, p), b)
        rec["metrics"] = {k: float(v) for k, v in met.items()}
        rec["state"] = (np_, ns)
        ref[scfg.name] = rec
    return ref


def families_mesh_phase(fcfg: dict, dev) -> tuple[dict, dict]:
    """Phase ``families_mesh``: the parent computes the one-process logits
    on the card, freeing it after each model, then one spawned world of four
    ranks runs every model in turn, then (c) and (d); every check is the
    parent's. Returns (the launches of the guards' kernels, summed over the
    ranks, the phase's record)."""
    import multiprocessing as mp

    t0 = time.perf_counter()
    world = math.prod(MESH_SHAPE)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        check(held < MOE_HELD_MAX, f"families_mesh: earlier phases still hold {held} bytes of the card")
    ctx = mp.get_context("spawn")  # the parent has initialised CUDA: no fork
    tmp = tempfile.TemporaryDirectory()
    go, out = ctx.Event(), ctx.Queue()
    init = "file://" + os.path.join(tmp.name, "store")
    procs = [ctx.Process(target=families_mesh_worker, args=(r, world, init, fcfg, go, out, dev.type), daemon=True)
             for r in range(world)]
    parts = [a for a, _ in FM_MODELS] + ["small", "launcher"]
    results: dict = {}
    try:
        for p in procs:
            p.start()
        t_ref = time.perf_counter()
        ref = fm_reference(dev, fcfg)
        ref_s = time.perf_counter() - t_ref
        go.set()
        want, got, deadline = world * (len(parts) + 2), 0, time.monotonic() + FM_DEADLINE_S  # ready, parts, done
        while got < want:
            try:
                status, rank, part, value = out.get(timeout=5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                check(not dead, f"families_mesh: rank(s) {dead} died (exit codes {[procs[r].exitcode for r in dead]})")
                check(time.monotonic() < deadline, f"families_mesh: the ranks did not finish within {FM_DEADLINE_S} s")
                continue
            check(status != "error", f"families_mesh: rank {rank} raised:\n{value}")
            got += 1
            if status == "ok":
                results.setdefault(part, {})[rank] = value
                if rank == 0:  # progress, on the error stream
                    print(f"chip_smoke: families_mesh/{part} done on rank 0 in {value['seconds']:.1f} s, "
                          f"{time.perf_counter() - t0:.1f} s into the phase: "
                          f"{json.dumps(untokened(value), default=str)[:3000]}",
                          file=sys.stderr, flush=True)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(30)
        tmp.cleanup()
    phase_s = time.perf_counter() - t0
    ranks = range(world)
    on_card = dev.type == "cuda"
    counted = {"gf_matmul": 0, "butterfly_mac": 0}

    # (a) and (b), model by model
    served = {}
    peaks_of = {}
    for arch, layers in FM_MODELS:
        m, sv = fcfg["models"][arch], results[arch]
        toks = sv[0]["plain"]["tokens"]
        check(all(sv[r]["plain"]["tokens"] == toks for r in ranks), f"families_mesh/{arch}: the ranks' tokens differ")
        check(all(len(toks[b]) == len(p) + FM_MAX_NEW and toks[b][:len(p)] == p
                  and all(0 <= t < m["cfg"].vocab_size for t in toks[b]) for b, p in enumerate(m["prompts"])),
              f"families_mesh/{arch}: a row's tokens are not its prompt and its budget in the vocabulary")
        check(all(sv[r]["placed"] and sv[r]["engine_kept_blocks"] for r in ranks),
              f"families_mesh/{arch}: the sharded draw did not give the engine DTensors it kept")
        check(all(sv[r]["held_bytes"] == m["held"] for r in ranks),
              f"families_mesh/{arch}: ranks hold {[sv[r]['held_bytes'] for r in ranks]} bytes, the specs say {m['held']}")
        check(all(sv[r]["draw_peak_bytes"] <= m["held"] + MM_DRAW_SLACK for r in ranks),
              f"families_mesh/{arch}: a rank's draw peaked at {[sv[r]['draw_peak_bytes'] for r in ranks]} bytes")
        peaks = [sv[r]["peak_bytes"] for r in ranks]
        peaks_of[arch] = peaks
        check(not on_card or sum(peaks) <= FM_PEAK_SUM_MAX,
              f"families_mesh/{arch}: the ranks' peaks {peaks} pass {FM_PEAK_SUM_MAX} bytes together")
        pr, rb, rf = sv[0]["probe"], ref[arch]["bfloat16"], ref[arch]["float32"]
        near_tie = rb["routes"] != rf["routes"]
        lerr = {k: {"mesh_vs_one_process": logits_err(pr[k], rb[k]), "mesh_vs_float32": logits_err(pr[k], rf[k]),
                    "one_process_vs_float32": logits_err(rb[k], rf[k])} for k in ("prefill", "tick")}
        for k, e in lerr.items():
            one, mesh, exact = e["mesh_vs_one_process"], e["mesh_vs_float32"], e["one_process_vs_float32"]
            check(one["finite"] and (near_tie or (one["rms_of_rms"] <= REFEED_RMS_TOL
                                                  and one["max_of_max"] <= REFEED_MAX_TOL)),
                  f"families_mesh/{arch}: the full-width {k} logits differ from one process's: {e}")
            check(all(mesh[q] <= max(tol, FM_EXACT_SLACK * exact[q])
                      for q, tol in (("rms_of_rms", REFEED_RMS_TOL), ("max_of_max", REFEED_MAX_TOL))),
                  f"families_mesh/{arch}: the full-width {k} logits are further from float32's than one process's: {e}")
        p0 = sv[0]["plain"]
        rec = {"layers": f"{layers or m['cfg'].n_layers} of {get(arch).n_layers}", "whole_bytes": m["whole"],
               "held_bytes_by_specs": m["held"], "held_bytes": [sv[r]["held_bytes"] for r in ranks],
               "draw_s": [sv[r]["draw_s"] for r in ranks], "draw_peak_bytes": [sv[r]["draw_peak_bytes"] for r in ranks],
               "peak_bytes": peaks, "prompt_lens": [len(p) for p in m["prompts"]], "max_new": FM_MAX_NEW,
               "tokens_equal_across_ranks": True, "logits_err": lerr,
               "logits_tolerance": {"rms_of_rms": REFEED_RMS_TOL, "max_of_max": REFEED_MAX_TOL,
                                    "of_float32": f"the larger of these and {FM_EXACT_SLACK} x one process's"},
               "router_near_tie": near_tie, "router_calls": len(rb["routes"]),
               "tokens_per_s": p0["tokens_per_s"], "wall_s": p0["wall_s"], "ticks": p0["steps"],
               "tick_ms": [sv[r]["plain"]["tick_ms"] for r in ranks], "counted_tick": sv[0]["counted_tick"],
               "seconds": [sv[r]["seconds"] for r in ranks]}
        if arch in FM_RECURRENT:
            g0 = sv[0]["guarded"]
            entry = FM_ENTRY.format(arch=arch)
            want_calls = count_calls(fcfg["runs"][entry])
            check(all(sv[r]["guarded"]["dead"] == [FM_KILL_HOST] and sv[r]["guarded"]["alive"] == [0, 1, 2]
                      and sv[r]["guarded"]["host"] == r for r in ranks),
                  f"families_mesh/{arch}: guard {[sv[r]['guarded']['dead'] for r in ranks]}")
            check(g0["bit_exact"], f"families_mesh/{arch}: the recovered state differs from the snapshot's bytes")
            check(all(sv[r]["guarded"]["resumed_equal"] for r in ranks),
                  f"families_mesh/{arch}: the refeed resumed from the recovered state gives other tokens than (a)")
            check(g0["width"] == m["S"], f"families_mesh/{arch}: rows {g0['width']} limbs wide, not phase 3's {m['S']}")
            for r in ranks:
                gr = sv[r]["guarded"]
                check(gr["calls"] == fcfg["runs"][entry], f"families_mesh/{arch}: rank {r} runs other kernels than "
                                                          "phase 3 held")
                check(not on_card or (gr["kernels"] == "cuda" and (gr["launches"]["gf_matmul"],
                                                                   gr["launches"]["butterfly_mac"]) == want_calls),
                      f"families_mesh/{arch}: rank {r} launched {gr['launches']}, expected {want_calls}")
                for k in counted:
                    counted[k] += gr["launches"][k]
            rec["guarded"] = {"K": CM_K, "R": CM_R, "snapshot_tick": FM_SNAPSHOT_TICK, "lost_ticks": FM_LOST_TICKS,
                              "killed_host": FM_KILL_HOST, "recovered_bit_exact": True,
                              "resumed_to_tick": g0["resumed_to_tick"],
                              "resumed_tokens_equal": True, "row_limbs": g0["width"],
                              "state_bytes": spec_bytes(fm_state_spec(build_model(m["cfg"]), m["prompts"])),
                              "snapshot_ms": [sv[r]["guarded"]["snapshot_ms"] for r in ranks],
                              "recover_ms": [sv[r]["guarded"]["recover_ms"] for r in ranks],
                              "transport": g0["transport"], "launches": [sv[r]["guarded"]["launches"] for r in ranks]}
        served[arch] = rec
    check(not on_card or counted["gf_matmul"] > 0, "families_mesh: the guard never launched gf_matmul")

    # (c) the float32 smoke configs on the mesh on the card against the CPU; the train launcher
    sm = results["small"]
    small_rec = {}
    for scfg in fcfg["small"]:
        name = scfg.name
        check(all(sm[r][name]["tokens"] == ref[name]["tokens"] for r in ranks),
              f"families_mesh/small: {name}'s tokens on the mesh differ from the CPU's")
        (gp, gs), (cp, cs) = sm[0][name]["state"], ref[name]["state"]
        worst, tol = small_errors(gp, gs, [sm[0][name]["metrics"]["loss"]], cp, cs, [ref[name]["metrics"]["loss"]],
                                  [ref[name]["metrics"]["lr"]])
        gn = abs(sm[0][name]["metrics"]["grad_norm"] - ref[name]["metrics"]["grad_norm"]) / ref[name]["metrics"]["grad_norm"]
        check(all(worst[k] <= tol[k] for k in worst) and gn <= MM_NORM_RTOL,
              f"families_mesh/small: {name}'s train step on the mesh and the CPU's differ: {worst}, norm {gn}")
        small_rec[name] = {"tokens_equal_cpu": True, "max_err": worst, "tolerance": tol, "grad_norm_rel_err": gn}
    tl_rec = {}
    for arch in FM_TRAIN_ARCHS:
        tl = [sm[r]["train_launcher"][arch] for r in ranks]
        check(all(t["losses"] == tl[0]["losses"] and np.isfinite(t["losses"]).all() and t["step"] == 1
                  and t["placed"] for t in tl), f"families_mesh/train_launcher: {arch}: {tl[0]}")
        check(tl[0]["held"] and tl[0]["one_process_equal"],
              f"families_mesh/train_launcher: {arch}'s parity differs from a one-process guard's over the gathered state")
        entry = FM_TRAIN_ENTRY.format(arch=arch)
        want_calls = count_calls(fcfg["train_runs"][entry])
        for r in ranks:
            exp = want_calls if r == 0 else (0, 0)
            got_l = (tl[r]["launches"]["gf_matmul"], tl[r]["launches"]["butterfly_mac"])
            check(not on_card or got_l == exp, f"families_mesh/train_launcher: {arch}: rank {r} launched {got_l}, "
                                               f"expected {exp}")
            for k in counted:
                counted[k] += tl[r]["launches"][k]
        tl_rec[arch] = {"losses": tl[0]["losses"], "parity_equal_one_process": True, "launches_rank0": tl[0]["launches"]}

    # (d) the launcher's own sharded draw: the first tokens of (a)'s Whisper rows
    ln = results["launcher"]
    wt = results[WHISPER_ARCH][0]["plain"]["tokens"]
    cut = [row[:len(p) + FM_LAUNCH_NEW] for row, p in zip(wt, fcfg["models"][WHISPER_ARCH]["prompts"])]
    check(all(ln[r]["tokens"] == cut for r in ranks),
          "families_mesh/launcher: launch/serve.py --mesh 2x2 gives other tokens than (a)'s engine")
    check(any(line.startswith("seq 0:") for line in ln[0]["printed"]) and not any(ln[r]["printed"] for r in ranks if r)
          and "falling back to fixed-batch" in ln[0]["printed"][0],
          "families_mesh/launcher: rank 0 alone must print the fall-back and the sequences")
    check(phase_s <= FM_PHASE_S, f"families_mesh: the phase took {phase_s:.1f} s, over {FM_PHASE_S} s")
    record = {"mesh": dict(zip(MESH_AXES, MESH_SHAPE)), "rules": "decode preset, opt profile", "models": served,
              "peak_sum_bytes": {a: sum(p) for a, p in peaks_of.items()}, "small": small_rec,
              "train_launcher": tl_rec,
              "launcher": {"tokens_equal_engine": True, "max_new": FM_LAUNCH_NEW, "printed": ln[0]["printed"],
                           "peak_bytes": [ln[r]["peak_bytes"] for r in ranks]},
              "seconds_by_part": {part: [results[part][r]["seconds"] for r in ranks] for part in results},
              "launches": counted, "reference_s": ref_s, "seconds": phase_s}
    return counted, record


# The device bytes each entry point added while its encodes ran the whole width at once (ROADMAP B1), on an NVIDIA
# H100 80GB HBM3: phase 6's by tools/coded_snapshot_memory.py in that tree, the mesh launcher's guard as rank 0's
# peak in this script's phase 16; the full-width train snapshot needed ~43x its 17.2 GB state and was not run
MEMORY_BEFORE = {"CodedStateGuard.snapshot": "21.64 GB", "encode_parity_collective": "13.34 GB",
                 "encode_parity_collective(4, 4)": "13.34 GB", "CodedServeGuard.snapshot": "17.54 GB",
                 "CodedServeGuard.snapshot(collective=True)": "14.72 GB", "lcc_encode": "2.28 GB",
                 CM_ENTRIES["launch"]: "27.48 GB peak on rank 0 at 28 layers", TRAIN_SNAPSHOT: "not run",
                 CM_ENTRIES["train_full"]: "not run"}


def memory_table(coded_cfgs: list[dict], coded: dict, trained: dict, meshed: dict) -> list[dict]:
    """The device bytes of every entry point that encodes in column blocks,
    from the records of phases 6, 8 and 16, each beside its bound and its
    bytes before the blocks (``MEMORY_BEFORE``): a snapshot adds at most
    SNAPSHOT_ADDED_MAX, an entry point that returns a tensor at most its
    output and SNAPSHOT_ADDED_MAX, the guard on rank 0 of the mesh at most
    the state it gathers and SNAPSHOT_ADDED_MAX. Fails the run when a row
    passes its bound."""
    cfg = {c["name"]: c for c in coded_cfgs}
    out_bytes = {"encode_parity_collective": 4 * CKPT_K * cfg["coded_checkpoint"]["S"],
                 "encode_parity_collective(4, 4)": 4 * CKPT_K * cfg["coded_checkpoint"]["S"],
                 "lcc_encode": 4 * SQUARE_K * cfg["lcc_square"]["S"]}
    rows = []

    def row(phase, entry, mem, extra):
        rows.append({"phase": phase, "entry": entry, **{k: mem[k] for k in ("held_bytes", "peak_bytes", "added_bytes")},
                     "bound_bytes": extra + SNAPSHOT_ADDED_MAX, "before": MEMORY_BEFORE[entry]})
        check(mem["added_bytes"] <= extra + SNAPSHOT_ADDED_MAX,
              f"memory: {entry} added {mem['added_bytes']} device bytes, over {extra + SNAPSHOT_ADDED_MAX}")

    for name in ("coded_checkpoint", "lcc_serve", "lcc_square"):
        for entry, mem in coded[name]["memory"].items():
            if entry in MEMORY_BEFORE:
                row("coded", entry, mem, out_bytes.get(entry, 0))
    row("train", TRAIN_SNAPSHOT, trained["full_width"]["snapshot"], 0)
    for entry, part in ((CM_ENTRIES["launch"], "launcher"), (CM_ENTRIES["train_full"], "train_full")):
        for mem in meshed[part]["rank0_snapshot_memory"]:
            row("coded_mesh", entry, mem, mem["state_bytes"])
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this run needs one CUDA device",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    P = PAYLOAD
    smi = nvidia_smi_line()
    say("env", python=sys.version.split()[0], torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0), nvidia_smi=smi,
        total_memory=torch.cuda.get_device_properties(0).total_memory, mem_total=mem_total())

    _build.build_all()
    nvcc_version = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True, text=True,
                                  timeout=60).stdout.strip().splitlines()[-2:]
    say("build", seconds=_build.build_report["seconds"], nvcc=nvcc_version,
        sources={k: {"compiled": v["compiled"], "library": os.path.relpath(v["library"], ROOT),
                     "ptxas": ptxas_by_kernel(v["log"])}
                 for k, v in _build.build_report["sources"].items()})

    # phase 3: kernels against their plain versions, at every shape phase 4 gives them
    configs = make_configs()
    coded_cfgs = coded_configs()
    serve_cfg = serve_config()
    train_cfg = train_config()
    ranks_cfgs = ranks_configs()
    moe_cfg = moe_config()
    mla_cfg = mla_config()
    ssm_cfg = ssm_config()
    encvlm_cfg = encvlm_config()
    analysis_cfgs = analysis_configs()
    cm_cfg = coded_mesh_config()
    mm_cfg = moe_mesh_config()
    fm_cfg = families_mesh_config()
    shapes = path_shapes(configs + coded_cfgs + [serve_cfg, train_cfg] + ranks_cfgs
                         + [moe_cfg, mla_cfg, ssm_cfg, encvlm_cfg] + analysis_cfgs + cm_cfg["paths"]
                         + mm_cfg["paths"] + fm_cfg["paths"], P)
    t_kernels = time.perf_counter()
    rows = [
        check_gf_matmul(dev, shapes["gf_matmul"]),
        check_butterfly_mac(dev, shapes["butterfly_mac"]),
    ]
    say("kernels", card=smi, copy_1GiB=attained_copy(dev), kernels=rows, seconds=time.perf_counter() - t_kernels)
    torch.cuda.empty_cache()

    # phase 4: the main path, with every count set to 0 just before it
    gf_matmul_cuda.launches = 0
    butterfly_mac_rows_cuda.launches = 0
    records, timers = {}, {}
    for cfg in configs:
        if cfg["kind"] == "topology":
            record, fn, x = drive_entry(cfg, dev, P)
            records[cfg["name"]], timers[cfg["name"]] = record, (lambda fn=fn, x=x: fn(x),)
            if cfg["name"] == "pipelined":
                cfg["pipelined"] = (fn, x)
        else:
            records[cfg["name"]], timers[cfg["name"]] = drive_encode(cfg, dev, P)
        torch.cuda.empty_cache()
    main_path_launches = {
        "gf_matmul": gf_matmul_cuda.launches,
        "butterfly_mac": butterfly_mac_rows_cuda.launches,
    }
    for k, n in main_path_launches.items():
        check(n > 0, f"the main path never launched {k}")

    # times of the encodes (these repeats are not part of the counted run)
    for cfg in configs:
        name = cfg["name"]
        record = records[name]
        entries = dict(zip(cfg["entries"], timers[name]))
        if name == "pipelined":  # the same IR with its overlap LocalOps run in order
            fn, x = cfg.pop("pipelined")
            fn_in_order = ir_encode(in_order(fn.ir), q=cfg["q"], kernels="cuda")
            check(same(fn_in_order(x), fn(x)), "pipelined: the in-order run differs")
            entries["in_order"] = lambda f=fn_in_order, x=x: f(x)
            turns = [(k, wall_ms(entries[k], ENCODE_REPS))
                     for k in ("ps_encode", "in_order", "in_order", "ps_encode")]
            record["overlap_vs_in_order_ms"] = [{"run": k, "ms": ms} for k, ms in turns]
        for entry, run in entries.items():
            run()
            record[f"{entry}_ms"] = wall_ms(run, ENCODE_REPS)
        record["profile"] = {
            entry: profile_encode(f"{name}/{entry}", run, ENCODE_REPS) for entry, run in entries.items()
        }
        if name in ("dft", "draw_loose"):  # draw-and-loose scales once before its loose step
            check_not_fed(f"{name}/a2a_encode", record["profile"]["a2a_encode"], int(name == "draw_loose"))
        say(name, card=smi, **record)
        del entries
        timers[name] = None
        torch.cuda.empty_cache()

    # phase 5: the traced path, counted on its own
    gf_matmul_cuda.launches = 0
    butterfly_mac_rows_cuda.launches = 0
    traced = traced_phase(next(c for c in configs if c["name"] == "multilevel"), dev, P)
    check(gf_matmul_cuda.launches > 0, "the traced path never launched gf_matmul")
    say("traced", card=smi, launches={"gf_matmul": gf_matmul_cuda.launches,
                                      "butterfly_mac": butterfly_mac_rows_cuda.launches}, **traced)
    torch.cuda.empty_cache()

    # phase 6: the coded path, counted on its own
    coded_launches, coded = coded_phase(coded_cfgs, dev)
    for name, record in coded.items():
        say(name, card=smi, **record)
    say("coded", card=smi, launches=coded_launches)

    # phase 7: the serving path at full width, counted on its own
    serve_launches, served = serve_phase(serve_cfg, dev)
    say("serve", card=smi, **served)

    # phase 8: training at full width, and the resumes at the reference test's cut, counted on its own
    train_launches, trained = train_phase(train_cfg, dev)
    say("train", card=smi, **trained)

    # phase 9: the encode on K ranks that share the card, counted on the ranks
    ranks_launches, ranked = ranks_phase(ranks_cfgs, dev)
    say("ranks", card=smi, launches=ranks_launches, **ranked)

    # phase 10: the MoE family at Arctic's full width, two layers, on an emptied card, counted on its own
    moe_launches, moed = moe_phase(moe_cfg, dev)
    say("moe", card=smi, **moed)

    # phase 11: MLA, the prefix and MTP at DeepSeek-V3's full width, four layers, on an emptied card
    mla_launches, mlad = mla_phase(mla_cfg, dev)
    say("mla", card=smi, **mlad)

    # phase 12: the SSM families, RWKV6-3B at 4 and Jamba at 8 of 32 layers, each on an emptied card
    ssm_launches, ssmd = ssm_phase(ssm_cfg, dev)
    say("ssm", card=smi, **ssmd)

    # phase 13: the encoder-decoder and VLM families, Whisper-base whole and InternVL2-26B at 6 layers, each on an emptied card
    encvlm_launches, encvlmd = encvlm_phase(encvlm_cfg, dev)
    say("encdec_vlm", card=smi, **encvlmd)

    # phase 14: the examples and trace_encode on the card, counted on their own; the roofline shares; the dry run
    analysis_launches, analysisd = analysis_phase(analysis_cfgs, dev, served, trained, serve_cfg, smi)
    say("analysis", card=smi, **analysisd)

    # phase 15: the sharding substrate, Qwen3-1.7B served and trained on a 2x2 mesh of four ranks on the card
    gc.collect()
    torch.cuda.empty_cache()
    say("mesh", card=smi, **mesh_phase(mesh_config(), dev))

    # phase 16: the coded guards on the 2x2 mesh, counted on the ranks
    gc.collect()
    torch.cuda.empty_cache()
    coded_mesh_launches, coded_meshed = coded_mesh_phase(cm_cfg, dev)
    say("coded_mesh", card=smi, **coded_meshed)
    say("memory", card=smi, mem_total=mem_total(), rows=memory_table(coded_cfgs, coded, trained, coded_meshed))

    # phase 17: DeepSeek-V3 at full width on the 2x2 mesh, each rank drawing its own blocks, counted on the ranks
    gc.collect()
    torch.cuda.empty_cache()
    moe_mesh_launches, moe_meshed = moe_mesh_phase(mm_cfg, dev)
    say("moe_mesh", card=smi, **moe_meshed)

    # phase 18: RWKV6-3B, Jamba, Whisper-base and InternVL2-26B at full width on the 2x2 mesh, counted on the ranks
    gc.collect()
    torch.cuda.empty_cache()
    families_mesh_launches, families_meshed = families_mesh_phase(fm_cfg, dev)
    say("families_mesh", card=smi, **families_meshed)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    for row in rows:
        row["launches"] = (main_path_launches[row["name"]] + coded_launches[row["name"]]
                           + serve_launches[row["name"]] + train_launches[row["name"]]
                           + ranks_launches[row["name"]] + moe_launches[row["name"]] + mla_launches[row["name"]]
                           + ssm_launches[row["name"]] + encvlm_launches[row["name"]]
                           + analysis_launches[row["name"]] + coded_mesh_launches[row["name"]]
                           + moe_mesh_launches[row["name"]] + families_mesh_launches[row["name"]])
    print(json.dumps({"kernels": [{k: row[k] for k in keys} for row in rows]}), flush=True)
    say("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
