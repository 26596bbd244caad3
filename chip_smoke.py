#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and check them.

    python3 chip_smoke.py

Run from a checkout on a machine with an NVIDIA H100 (sm_90a) and the CUDA
toolkit.  Eight paths run on the card: the operator chain (soft rank /
sort and the losses, on the PAV kernels), the soft-op serving engine
(``launch/serve.py --engine``, on the PAV kernels), the LM server of
deepseek-v2-lite-16b at full width and depth (on the soft top-k router and
the flash-attention kernel at MLA's widths) and its trainer at full width
(on the PAV kernel and flash attention under autograd), the LM server
and trainer of llama3.2-1b, the dense GQA family, at full width and depth
(on the flash-attention kernel at head width 64, and the trainer's
soft-LTS loss on the PAV kernel), the LM server and trainer of
tinyllama-1.1b, the same family with an untied head, at full width and
depth (on the same kernel at G = 8: 32 query heads over 4 kv heads), and
the LM server of grok-1-314b, the
``moe`` kind, at full width and 6 of 64 layers (on the flash-attention
kernel at head width 128 with G = 6, and the soft top-k router over 8
experts), and the LM server of gemma3-12b, the ``local`` / ``global``
kinds, at full width and depth (on the flash-attention kernel at head
width 256 with G = 2, 40 of its 48 layers under the sliding window of
1024), and the LM servers of stablelm-3b (LayerNorm and the GELU MLP, on
the kernel at head width 80) and recurrentgemma-2b (the ``rg`` kind beside
MQA at G = 10 under a window of 2048), both at full width and depth, with
the trainer of stablelm-3b whole and a check of recurrentgemma-2b's at one
block cycle, and the last three families, each at full width and depth:
xlstm-350m (the ``mlstm`` / ``slstm`` kinds, no kernel) served and trained,
llava-next-mistral-7b (the vision frontend: 576 patch embeddings before
the tokens, the kernel at head width 128 with G = 4) served, with a check
of its trainer at 4 of 32 layers, and musicgen-large (the audio frontend:
frame embeddings in, four codebook heads out, the kernel at head width 64
with G = 1) served at the steps' level and trained.  Beside them, every
smoke config of the reference (f32, head widths 16 and (24, 16)) served
and trained a step against the CPU, and the reference's four example
programs run on the card, on the CUDA-core attention kernel for f32 and
unbuilt widths.  Phases, each printing
its own lines; any failure raises and the script exits non-zero:

1. device   require CUDA; print the card's name and power limit.
2. build    build ``src/repro_torch/kernels/csrc/*.cu`` with nvcc, one
            process per source, in parallel.
3. kernels  hold ``pav_l2`` / ``pav_kl`` (both divide and conquer) against
            the plain stack machine on the card at (128, 1000) and
            (128, 2048), on random inputs, inputs with ties and constant
            rows, and a soft-rank dynamic range (z = -theta/eps, eps =
            1e-2).  Hold each against its own plain version, the
            divide-and-conquer ``pav_l2_scan`` / ``pav_kl_scan``, at
            (128, 1000), (128, 10000) and (1, 2**20) on the main path's
            solver inputs, random rows and an adversarial row (two
            decreasing ramps, the right one above the left, which the top
            level pools into one block), bit for bit (kl: or within
            1e-5 * (1 + max|plain|) with the reason printed), with the
            blocks that the backward reads from each output.  At
            (128, 10000) and (1, 2**20) the stack machine (its block counts
            too, for kl), the adversarial 2**20 rows' plain versions and the
            trimmed token loss's fwd+bwd on the port's CPU backend run on a
            CPU copy, in worker processes while phase 4 runs, on random
            rows and on the main path's own solver inputs; the comparisons
            close phase 4.  Hold ``soft_topk_gates`` bit for bit (at
            (4096, 64) and (8, 64), k = 6, on random logits, ties and
            constant rows, at E = 100, at k = 0, 1 and E, and at eps = 0.3,
            not a power of two, and 1e-2; and at grok's router, (4096, 8)
            and (8, 8), k = 2, eps 1, on random logits, ties and constant
            rows) and ``flash_attention`` at the three built widths
            (``ATTN_CHECK_SHAPES``: (D, Dv) = (192, 128) at the deepseek
            prefill shape, GQA and a ragged S; (64, 64) at the llama
            prefill shape (G 4), tinyllama's G 8 and a ragged S at both and
            at G 3, which does not divide the 128-row tile, with
            tinyllama's own cases at G 8 (``TINYLLAMA_ATTN_CASES``: its
            prefill and training shapes, 544 positions, a ragged S, Sq !=
            Skv, not causal); (128, 128) at
            the grok prefill shape (G 6) and a ragged S; each width also
            non-causal; by the kernel's error model ``compare_with_plain``)
            against their plain versions on the card, and (256, 256) at G 2
            (``GEMMA_ATTN_CASES``: gemma's prefill shape causal and under
            its window of 1024, a ragged S, windows of 100 and of one key,
            a window past Skv (bit for bit the causal output), ragged Sq
            and Skv under a window, and not causal), (256, 256) at G 10
            (``RG_ATTN_CASES``: recurrentgemma's prefill shape under its
            window of 2048 and causal, windows of one key and past Skv, an
            Sq that is no multiple of 12 positions a tile, not causal) and
            (80, 80) at G 1, run padded to 128 columns
            (``STABLELM_ATTN_CASES``: stablelm's prefill and training
            shapes, not causal, Sq != Skv, a ragged S), (128, 128) at G 4
            (``LLAVA_ATTN_CASES``: llava's 1088-position prefill and its
            training shape, a ragged S, Sq != Skv, not causal) and (64, 64)
            at G 1 (``MUSICGEN_ATTN_CASES``: musicgen's prefill and training
            shapes, a ragged S, not causal); at (64, 64), (128, 128) and
            (256, 256) the options no model path uses
            (``OPTION_ATTN_CASES``: a soft-cap of 30 with q scaled by 10 so
            that it binds, a query offset with Sq < Skv, a window without
            ``causal``, all three with a ragged Sq), forward and backward
            under autograd by the two error models.  The CUDA-core kernel
            ``flash_attention_simt`` (f32 on FFMA, bf16 at other widths on
            mma.sync; ``SIMT_ATTN_CASES``) against the plain version: f32
            at the smoke configs' (2, 48, 4, 16) G 2, causal and under
            their window of 32, MLA's smoke widths (24, 16), the MoE
            example's (8, 64, 4, 32) G 2, the robust LM example's --full
            (8, 128, 12, 64) G 3, a soft-cap of 30, a query offset and a
            window without ``causal``, by the f32 error model; bf16 at
            (96, 96), which the tensor-core kernel is not built for, causal
            and not, by the bf16 model; the tiles' edges (Sq * G no
            multiple of the row block over Skv != Sq, G 3, 6 and 200, D 8,
            (8, 256), (256, 256), bf16 at (40, 40), (24, 16) and (96, 64)
            and with a window, a soft-cap and a query offset) and the two
            prefill shapes of phase 5, one launch each; its backward
            at one f32 shape by the backward's model.  The route: bf16 at
            each built width launches the tensor-core kernel alone, f32 at
            (64, 64) the CUDA-core kernel alone, (264, 264) and (20, 20)
            raise with no launch of either.
4. main     fwd+bwd of soft_rank / soft_sort (l2, kl) and
            soft_spearman_loss at (128, 1000) and (128, 10000) (eps 0.1),
            and soft_trimmed_token_loss on 2**20 token losses (trim 0.1,
            eps 1e-2, the trainer's defaults); every launch
            counter must equal the number of its operator calls, and so
            must the dispatch layer's per-call counters
            (``dispatch_calls`` of the cuda solves and the fused
            projections, ``dispatch_bwd_calls`` of the scatter backwards,
            ``projection_fused_calls``; ``dispatch_shape`` one a solve).  The
            (128, 1000) values and gradients are held against the port on
            the CPU (plain backends), and z = -theta/eps is compared
            across the two devices.  Fault F2's check: soft_rank /
            soft_sort (l2, kl) on f64 tensors on the card (the built-in
            plan's scan route) against the CPU at 1e-10, values and
            gradients, with no PAV launch.  Every phase runs under the
            packaged plan (``src/repro_torch/plan/default_plan.json``,
            measured on the card), so the counters and launches are
            derived from the plan chain's decision at each call's shape.
   plan     the smoke tier of ``repro_torch.tools.sweeps`` (soft_rank by
            backend at (64, 1024) x (1, 8), the projection paths at
            (8, 1024)) on the card into a temporary directory: every row
            finite or skipped with its reason (the stack machine past a
            2 s budget); at (8, 1024) every backend that ran within 1e-5
            * (1 + max|cuda|) of the cuda kernel in value and in the VJP
            of a random cotangent, and the kernels bit for bit their plain
            versions on soft_rank's solver inputs; a plan derived from
            those artifacts passes check 5; checks 1, 2, 3 and 5
            (``repro_torch.tools.check_backends``) pass on the committed
            plan, its evidence and the README; then the packaged plan's
            hash, its decision and source at the main path's shapes (the
            operators', the router's, soft-LTS's, the engine's; an f64
            solve must resolve to ``scan``), the shapes it routes away
            from the built-in plan with both backends' times from the
            evidence, and the phase's seconds.
   engine   ``repro_torch.launch.serve.main(["--engine", ...])`` with the
            reference's defaults (500 requests of n 64 to 4096 from seed
            0, max batch 32, max wait 2 ms, queue 1024, soft_rank and
            soft_sort l2 desc), writing a BENCH artifact that
            ``repro_torch.obs.artifacts`` validates; then 500 requests over
            the 12 desc or undirected ops (l2 and kl).  Each with the PAV
            counters from 0: no shed, no error, ``aot_cache_miss`` 0 after
            warm-up, every cell on the backend the plan chain decides at
            its (rows, bucket) (``cuda`` at every cell under the packaged
            plan), one solve per executed batch plus one per warmed cell,
            and ``pav_l2`` / ``pav_kl`` launched as many times as
            ``dispatch_calls`` counts cuda solves (the counters printed
            beside ``dispatch_resolve``).  Every vector result equals the
            unpadded port call on the card bit for bit (the packaged plan
            bounds no rule by rows, so a cell and its unpadded calls
            resolve alike), scalars within 1e-5 relative,
            and every result is within 1e-5 * (1 + max|CPU|) of the
            unpadded port call on the CPU (computed by the CPU workers).
            Padding at the buckets' edges (n = 64, 65, 2048, 2049, 4096,
            random and ties) is held bit for bit too.
   serve    ``repro_torch.launch.serve`` on deepseek-v2-lite-16b: random
            bf16 weights from seed 0, 8 prompts of 512 tokens from the
            port's TokenPipeline, prefill and 31 greedy decode steps.  Each
            prefill launches flash_attention and soft_topk_gates once per
            layer (27), each decode step soft_topk_gates 27 times, and no
            PAV kernel runs.  Logits are finite and every gate row sums to
            k.  Each kernel is held against its plain version on the inputs
            it got in every layer of that prefill (the gates bit for bit);
            a second prefill on the plain versions counts the routing
            decisions that differ.
   serve llama3.2-1b (after phase 5's times, the deepseek server's
            model freed): the same server, seed, prompts and generation at
            full width and depth (16 layers, 1,235,814,400 bf16 parameters
            with the tied table).  Each prefill launches flash_attention
            once a layer (16), each decode step decode_attention once a
            layer; no gate and no PAV kernel runs.  Logits are
            finite; the kernel is held against its plain version on every
            layer's captured inputs; a plain-path prefill gives the logit
            difference and the first token's agreement; the weights' bytes,
            the init's peak and the serving peak apart.  Then the kernel,
            plain and SDPA times at the prefill shape, prefill ms, decode
            tok/s and the profiled prefill and decode step.
   serve llama3.2-1b in f32 (``--set dtype=float32``, after the bf16
            server's model is freed): the same server at full width and
            depth in f32.  Each prefill launches flash_attention_simt once
            a layer (16, the FFMA path), each decode step
            decode_attention once a layer (its f32 path), nothing else;
            logits finite;
            the kernel held to the f32 error model on every layer's
            captured inputs; a plain-path prefill; prefill ms, decode
            tok/s, and the kernel's share of one profiled prefill's device
            time.
   serve grok-1-314b (after the llama server's model is freed, before
            the trainers, with under 1 GiB allocated):
            ``serve.main(["--arch", "grok-1-314b", "--set",
            "num_layers=6", ...])``, the command a user runs, at full
            width (d_model 6144, 48 heads over 8 kv heads of 128, 8 experts
            of 32768, top-2, vocabulary 131072, untied head, soft-cap 30),
            6 of 64 layers (31,130,499,072 bf16 parameters, 58 GiB), seed
            0, the same prompts and generation.  Each prefill launches
            flash_attention and soft_topk_gates once a layer (6 each), each
            decode step decode_attention and soft_topk_gates 6 times each
            and flash_attention none;
            no PAV kernel runs.  Logits are finite and within the soft-cap;
            gate rows sum to k = 2; the attention kernel is held to its
            error model on every layer's captured prefill inputs and the
            gates bit for bit on every captured call; a plain-path prefill
            gives the routing decisions that differ, the logit difference
            and the first token's agreement; the weights' bytes, the init's
            peak and the serving peak.  Then the kernel, plain and SDPA
            (``enable_gqa``) times at the prefill shape, the gates' at
            (4096, 8) and (8, 8), prefill ms, decode tok/s and the profiled
            prefill and decode step.
   serve tinyllama-1.1b (after the grok server's model is freed, the
            first of ``FULL_SERVE_RUNS``): ``serve.main`` as the
            reference configures it, nothing cut (22
            ``dense`` layers, d_model 2048, 32 heads over 4 kv heads of 64,
            SwiGLU of 5632, vocabulary 32000, untied head; 1,100,048,384
            bf16 parameters), seed 0, 8 prompts of 512 tokens, 32
            generated: 22 flash_attention launches a prefill in the layers'
            order, none windowed, the kernel at (64, 64) with G = 8; a
            decode step decode_attention once a layer; no gate, PAV or
            CUDA-core launch; logits
            finite; the kernel held to its error model on every layer's
            captured inputs; a plain-path prefill; the kernel, plain and
            SDPA (``enable_gqa``) times at the prefill shape, prefill ms,
            decode tok/s, the peaks and the profiled steps.
   serve gemma3-12b (after the tinyllama server's model is freed, with
            under 1 GiB allocated): ``serve.main(["--arch",
            "gemma3-12b", ...])``
            as the reference configures it, nothing cut (48 layers in a 5:1
            cycle of ``local`` (window 1024) and ``global``, d_model 3840,
            16 heads over 8 kv heads of 256, GeGLU of 15360, vocabulary
            262144, tied; 11,765,395,200 bf16 parameters, 21.9 GiB), seed
            0, 8 prompts of 2048 tokens (at 512 the window never binds),
            32 generated.  Each prefill launches flash_attention once a
            layer (48: 40 with the window, 8 without, in the cycle's
            order), a decode step decode_attention once a layer (the
            window's positions alone in the local layers); no gate and no
            PAV kernel.  Logits
            finite; every layer's cache full length (max_len 2080); the
            kernel held to its error model on every layer's inputs as it
            ran (kept are the first global and local layer's); a
            plain-path prefill gives the logit difference and the first
            token's agreement; the weights' bytes, the init's peak and the
            serving peaks.  Then the kernel, plain and SDPA times at the
            global layer's shape (``is_causal``, ``enable_gqa``) and at the
            local layer's (SDPA with a boolean band mask, its backend
            named), prefill ms, decode tok/s, the peak over the timed runs
            and the profiled prefill and decode step.
   serve stablelm-3b and recurrentgemma-2b (after the gemma server's
            model is freed, each freed before the next): ``serve.main`` as
            the reference configures each, nothing cut, seed 0, 32
            generated.  stablelm-3b (32 ``dense`` layers, 32 heads of 80,
            LayerNorm, the GELU MLP of 6912, untied head; 2,229,212,160
            bf16 parameters, 4.15 GiB) on 8 prompts of 512 tokens: 32
            flash_attention launches a prefill, the kernel at (80, 80).
            recurrentgemma-2b (26 layers: 8 cycles of ``rg``, ``rg``,
            ``local`` and a trailing ``rg``, ``rg``; the RG-LRU block of
            2560; MQA of 10 heads over 1 kv head of 256 under a window of
            2048; GeGLU of 7680; tied; 2,894,435,840 parameters, 5.39 GiB)
            on 8 prompts of 4096 tokens, so that the window binds: 8
            windowed flash_attention launches a prefill (G 10), none in
            its rg layers, and every rg layer's f32 state finite after
            decode.  Both: a decode step launches decode_attention once an
            attention layer and nothing else; no gate and no
            PAV kernel; logits finite; the kernel held to its error model
            on every attention layer's inputs as it ran; a plain-path
            prefill; then the kernel, plain and SDPA times at the first
            attention layer's shape, prefill ms, decode tok/s, the peaks
            and the profiled prefill and decode step.
   serve xlstm-350m and llava-next-mistral-7b (each freed before the
            next, the same ``full_serve_path``): xlstm-350m (24 layers in 3
            cycles of 7 ``mlstm`` and 1 ``slstm``, 332,748,884 bf16
            parameters, 0.62 GiB) on 8 prompts of 512 tokens: no launch at
            all (its blocks are PyTorch ops), every mLSTM (C, n, m) and
            sLSTM (c, n, m, h) state finite f32 after decode, and the
            prefill again on the CPU (the plain path, bf16) for the first 2
            prompts: the logit difference and the first token's agreement;
            its profiled prefill and decode step give the sLSTM scans'
            share (host, device busy, launches: the ``repro_slstm_scan``
            range).  llava-next-mistral-7b (32 ``dense`` layers, 32 heads
            over 8 kv heads of 128, SwiGLU of 14336, untied; 7,241,732,096
            parameters, 13.49 GiB) on 8 prompts of ``--prompt-len 1088``,
            576 random patch embeddings from the pipeline and 512 tokens,
            decoding from position 1088 (the prefill's length, not the
            reference's 1664: fault R6): 32 flash_attention launches a
            prefill, decode_attention 32 a decode step, the kernel held on
            every layer's
            inputs, a plain-path prefill, the kernel, plain and SDPA
            (``enable_gqa``) times at the prefill shape.
   serve musicgen-large at the steps' level (``launch/steps.py``'s
            ``make_prefill_step`` / ``make_decode_step``, as the reference
            offers audio; its server refuses it): 48 layers, LayerNorm and
            the GELU MLP, 32 heads over 32 kv heads of 64, four codebook
            heads, no embedding (2,433,093,632 parameters, 4.53 GiB), seed
            0; 8 x 512 frame embeddings from the pipeline's audio branch,
            then 31 decode steps fed its next frames: 48 flash_attention
            launches a prefill (G 1), decode_attention 48 a decode step;
            (8, 4, 2048)
            logits finite; the kernel held on every layer's inputs; a
            plain-path prefill; the same times as the servers above.
5. times    CUDA-event medians per kernel (on the main path's solver
            inputs and on random rows), plain version, operator fwd and
            fwd+bwd, and torch.sort at the same shape as a yardstick; the
            serving kernels at the path's shapes (CUDA events, and each
            kernel's own device time from torch.profiler) beside their
            plain versions and, for attention,
            scaled_dot_product_attention as the library yardstick;
            prefill ms and decode tokens/s; one profiled prefill and
            decode step (device busy and idle share, top kernels); the
            engine's default stream three more times (warm-up seconds,
            req/s, p50/p95/p99 latency, batch occupancy, padding waste) and
            the PAV kernels at its largest cell (32, 4096); the fused
            projection's two Lemma 2 backwards, ``segscan`` and
            ``scatter``, at the train step's and the operators' shapes,
            against the plan chain's cuda backward rule; the attention
            kernel with each option (soft-cap 30, a query offset, a window
            without ``causal``) beside the same shape without it, at the
            llama, grok and gemma prefills; the CUDA-core kernel at the
            smoke and example shapes, bf16 (96, 96), llama3.2-1b's f32
            prefill and bf16 (96, 96) at llama's heads, with its launch plan
            (``simt_plan``; registers and spills from the build log),
            beside its plain version, SDPA on the same inputs (its backend
            named) and SDPA's memory-efficient backend on k and v expanded
            to H heads.
   fig4     (the deepseek server's model freed) Figure 4 (right) of the
            paper: ``soft_rank`` (l2, kl, eps 0.1) against the O(n^2)
            baselines of ``core/baselines.py``, all-pairs (tau 0.1) and OT
            / Sinkhorn (eps 1e-2, 50 iterations), forward and forward +
            backward of sum(r**2), on 128 rows of n = 100 to 10000; a run
            whose bytes, reckoned from the same method's peak at the
            largest n that ran times (n / n_ran)^2, would pass 90% of the
            card's memory is skipped and its reckoning printed.  First
            each baseline on the card against the CPU at (8, 100), and
            OT (eps 1e-3, 400 iterations) and all-pairs (tau 1e-3) within
            0.05 and 1e-3 of the hard ranks.
   smoke    (after Figure 4) fault F4's check: every config of
            ``all_smoke_configs()`` (f32, head width 16, MLA (24, 16))
            built on the CPU from seed 0 and carried to the card; on both
            a prefill of 2 x 16, 4 decode steps and one trimmed train step
            (trim 0.1): logits, loss, gradients and updated parameters
            within c * (1 + max|cpu|) (``SMOKE_C_*``: c from each model's
            measured amplification of one f32 rounding), launches a
            prefill, decode step and train step as counted from the code;
            TF32 off for products and cuDNN.
   examples (while phase 3's CPU workers finish, the deepseek server's
            model still held) the four example programs on the card
            through their ``main``: quickstart (held to its CPU run
            within 1e-5 * (1 + max|cpu|)), label ranking at its defaults
            (rho with and without the projection), robust LM training
            ``--full --steps 300`` (clean-token loss, baseline and
            soft-LTS) and the MoE router at its defaults (each router's
            loss and expert-load CV, the sampled tokens); wall seconds,
            steps/s, peak memory, and every kernel's launches, held to the
            counts from the code.
   experiments (after the examples) the paper's three quality
            experiments (``repro_torch.experiments``: Figure 4's top-k
            losses, Table 1's label ranking, Figures 6-7's soft LTS) at the
            reference's sizes and steps through their ``main``; the PAV
            kernels held bit for bit to their plain versions on the
            first and the last of the run's own solves at each shape;
            every row held to the same program on the CPU workers (the
            divide and conquer, submitted before phase 4) within
            ``repro_torch.experiments.BANDS``: each training's final
            weights within 1e-4 * (1 + max|cpu|), Fig. 6 within 1e-5 *
            (1 + |cpu|), R^2 and rho within 1e-4, accuracy within one
            test sample, every row finite; wall seconds, steps/s, peak
            memory, the PAV launches held to the counts from the code;
            then one line on the paper's four claims, each reproduced or
            not (a finding, not a check).
6. train    the servers' models freed, ``repro_torch.launch.train``'s
            ``main`` on each of ``TRAIN_RUNS``, one after the other:
            deepseek-v2-lite-16b at full width and 4 of 27 layers (the
            trainer's state at full depth, ~260 GB, needs several cards),
            the config's grad_accum 8; llama3.2-1b at full width and depth
            (16 layers, ~20 GB of state), the config's grad_accum 4;
            tinyllama-1.1b at full width and depth (22 layers, ~17.6 GB
            of state), the config's grad_accum 4, 176 flash_attention
            launches (G 8) and 4 pav_l2 a step; gemma3-12b at full
            width and one block cycle of 6 of 48 layers (~38 GB of
            state), the config's grad_accum 8, its first attention call a
            local layer's under the window; stablelm-3b
            whole (32 layers, ~36 GB of state), the config's grad_accum 8;
            recurrentgemma-2b, checks only, at full width and one block
            cycle (``rg``, ``rg``, ``local``: 3 of 26 layers, ~15 GB of
            state), 2 steps, its attention call under the window of 2048;
            xlstm-350m whole (~5.3 GB of state), the config's grad_accum 8,
            one step, timed (its 3 sLSTM scans run position by position,
            ~50 s a step: ``XLSTM_TRAIN_STEPS``), its profile one
            microbatch, with the scans' share; musicgen-large whole (~39
            GB of state), grad_accum 8, frames in and the four codebook heads' mean loss;
            llava-next-mistral-7b, checks only, at full width and 4 of 32
            layers (~18 GB of state; whole, ~116 GB, needs FSDP), 2 steps,
            each microbatch 576 patches and 1472 tokens; and llama3.2-1b
            whole once more under remat "dots" (``--set remat=dots``): its
            launches (attention is recomputed, as under "full"), its first
            step's losses against the "full" run's, step ms and peak.
            All: random bf16 weights from seed 0, AdamW steps of 8 x 2048
            positions with 10% corrupted targets, remat "full" (llama's
            second run "dots"), the
            soft-LTS token loss (trim 0.1).  Every step's launch counts equal the
            counts from the code (``train_launches_per_step``, by layer
            kind); losses and grad norms are finite; after step 1 every
            parameter leaf has a finite, non-zero gradient.  On captured
            inputs at the training shape: the attention kernel's forward
            and ``flash_attention_bwd`` (against the autograd of the plain
            version in f32) by their error models; deepseek's router
            ``soft_topk_mask`` fwd+bwd against the ``scan`` backend on the
            card (llama and gemma call no router); one AdamW update of a
            weight leaf, card against CPU, within one f32 ulp.  Then the
            step ms, tokens/s and peak memory, attention forward (and its
            plain version) and backward, with the captured call's window,
            beside scaled_dot_product_attention's (with a boolean band mask
            under a window), one profiled step and the optimizer by square
            root (for recurrentgemma and llava the attention times only).
mesh        the sharded main path on a one-rank NCCL group: meshes (1, 1)
            over (data, model) and (1, 1, 1) over (pod, data, model);
            ``pod_psum_int8`` through NCCL bit for bit the int8 round
            trip; llama3.2-1b's trainer whole for 2 steps with its
            parameters, state and batches distributed by the rules (FSDP
            on) against the same steps without a mesh, losses and every
            parameter bit for bit, launches as counted from the code; its
            parameters through a checkpoint, restored onto the mesh
            replicated, bit for bit; deepseek-v2-lite-16b served whole
            (8 x 512 and 4 decode steps) on the mesh against the same
            weights and tokens without it, logits bit for bit, 27
            attention and 27 gate launches a prefill, 27 gates a step;
            then the dry run (``launch/dryrun.py``), started after phase 3
            in CPU processes (no card) pinned to the host's last two
            cores, away from the timed phases, for llama3.2-1b and
            deepseek at the four shapes on 16 x 16 and one 2 x 16 x 16
            cell: each
            cell's dominant term, bound and bytes a device.
7. summary  one ``{"kernels": [...]}`` line (every kernel's launches by
            path; flash_attention's times by width, the top-level ones the
            MLA width's at the deepseek prefill, as before, gemma's
            (256, 256) at its global layers with the local layers' under
            ``local``; llava's (128, 128) at G 4, musicgen's (64, 64) at
            G 1 and tinyllama's (64, 64) at G 8 at their prefills, with
            their train launches; the gates'
            grok shapes under ``shapes``; the mesh phase's launches under
            ``mesh_launches``, the experiments' under
            ``experiment_launches``; ``flash_attention_simt`` with its launches
            by example program and smoke config and its rows by shape),
            then the device line last.

Inputs come from numpy with a fixed seed.  Imports nothing of JAX or of the
JAX package.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import multiprocessing
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# The card's constants, one source: H100 SXM data sheet, dense, HBM3
# bandwidth and bf16 tensor-core rate.
from repro_torch.analysis.roofline import (  # noqa: E402
    HBM_BW as HBM_BYTES_PER_S, PEAK_FLOPS as BF16_OPS_PER_S)
SEED = 0
TOKENS = 2**20
TRIM_FRACTION = 0.1
TRIM_EPS = 1e-2        # the trainer's default loss_trim_eps
EPS = 0.1              # benchmarks/bench_runtime.py's regularization_strength
SHAPES = ((128, 1000), (128, 10000))
KERNEL_SHAPES = (*SHAPES, (1, TOKENS))
HEADLINE = SHAPES[0]    # the shape of the kernels line
CPU_WORKERS = 6

# H100 SXM data sheet, dense: the f32 rate outside the tensor cores (the
# HBM bandwidth and the bf16 rate come from repro_torch.analysis.roofline).
# The bound is the larger of bytes / bandwidth and ops / rate.
F32_OPS_PER_S = 67e12
# Operations of the isotonic fit on these inputs, counted from
# csrc/pav_scan.cu: each position's singleton value and compare, each merge
# of two blocks (n - blocks of them), each block's value when expanding:
#   l2: position 3 (max, div, compare), merge 5 (2 adds, max, div,
#       compare), block 2 (max, div);
#   kl: position 2 (sub, compare), merge 14 (2 logaddexp of 6 ops each,
#       sub, compare), block 1 (sub).
OPS = {"pav_l2": (3, 5, 2), "pav_kl": (2, 14, 1)}
BYTES_PER_ELEM = {"pav_l2": 8, "pav_kl": 12}
REPLACES = {"pav_l2": "src/repro/kernels/pav.py:196",
            "pav_kl": "src/repro/kernels/pav.py:213",
            "soft_topk_gates": "src/repro/kernels/soft_topk.py:109",
            "flash_attention": "src/repro/kernels/flash_attention.py:83",
            "flash_attention_simt":
                "src/repro/kernels/flash_attention.py:83",
            "decode_attention": None}
# Names of each PAV kernel's CUDA kernels as the profiler shows them: the
# four kernels of each instantiation of csrc/pav_scan.cu carry its algebra
# in their template names.
DEVICE_NAMES = {"pav_l2": ("L2Algebra",), "pav_kl": ("KlAlgebra",)}
SOURCES = {"pav_l2": "src/repro_torch/kernels/csrc/pav_scan.cu",
           "pav_kl": "src/repro_torch/kernels/csrc/pav_scan.cu",
           "soft_topk_gates": "src/repro_torch/kernels/csrc/soft_topk.cu",
           "flash_attention":
               "src/repro_torch/kernels/csrc/flash_attention.cu",
           "flash_attention_simt":
               "src/repro_torch/kernels/csrc/flash_attention_simt.cu",
           "decode_attention":
               "src/repro_torch/kernels/csrc/decode_attention.cu"}
# The LM serving path: full config, 8 prompts of 512 tokens, 32 tokens out.
ARCH = "deepseek-v2-lite-16b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 512, 32
OPERATORS = ("soft_rank_l2", "soft_rank_kl", "soft_sort_l2", "soft_sort_kl",
             "soft_spearman_loss")


def check(ok: bool, what: str) -> None:
  if not ok:
    raise RuntimeError(f"check failed: {what}")


def say(*parts) -> None:
  print(*parts, flush=True)


T_START = time.perf_counter()


def clock(what: str) -> None:
  """A line with the seconds since the script started, after a phase: the
  script must end within its time limit, and these lines say where the
  time went."""
  say(f"clock: {what} at {time.perf_counter() - T_START:.1f} s")


def close(a: torch.Tensor, b: torch.Tensor, rel: float = 1e-5) -> float:
  """Max |a - b|, checked against rel * (1 + max|b|) (the reference's
  cross-backend contract, relative to the output's scale)."""
  a, b = a.detach().double().cpu(), b.detach().double().cpu()
  check(a.shape == b.shape, f"shapes {tuple(a.shape)} vs {tuple(b.shape)}")
  check(bool(torch.isfinite(a).all()), "non-finite values")
  err = float((a - b).abs().max()) if a.numel() else 0.0
  tol = rel * (1.0 + float(b.abs().max()))
  check(err <= tol, f"max |diff| {err:.3e} > {tol:.3e}")
  return err


def median_ms(fn, reps: int, warmup: int = 1) -> float:
  """Median device time of ``fn`` over ``reps`` calls, from CUDA events."""
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


def card() -> str:
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, check=True, timeout=60).stdout
  return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Inputs (numpy, fixed seed).
# ---------------------------------------------------------------------------


def solver_inputs(rng, rows: int, n: int, kind: str):
  """(y for l2, (s, w) for kl) as f32 numpy arrays of shape (rows, n)."""
  if kind == "random":
    s = rng.normal(size=(rows, n))
    w = rng.normal(size=(rows, n))
    return s - w, (s, w)
  if kind == "ties":
    s = np.round(rng.normal(size=(rows, n)) * 2) / 2
    w = np.round(rng.normal(size=(rows, n)) * 2) / 2
    s[::7] = 1.5   # constant rows
    w[::7] = 0.5
    return s - w, (s, w)
  if kind == "soft_rank":
    eps = 1e-2
    theta = rng.normal(size=(rows, n))
    s = -np.sort(theta, axis=-1) / eps         # sort_desc(-theta / eps)
    w = np.broadcast_to(np.arange(n, 0, -1), (rows, n))
    return s - w, (s, w)
  raise ValueError(kind)


def main_solver_inputs(theta: torch.Tensor | None,
                       tokens: torch.Tensor | None):
  """The main path's (s, w) solver input, computed on the card as the
  operators compute it: soft_rank's sort_desc(-theta / eps) against rho for
  a batch of scores, soft_sort's rho / eps against sort_desc(tokens) for
  the token row."""
  if theta is not None:
    n = theta.shape[-1]
    s = torch.sort(-theta / EPS, descending=True).values
    w = torch.arange(n, 0, -1, device=theta.device,
                     dtype=torch.float32).expand(theta.shape)
  else:
    n = tokens.numel()
    s = (torch.arange(n, 0, -1, device=tokens.device, dtype=torch.float32)
         / TRIM_EPS).expand(1, n)
    w = torch.sort(tokens.reshape(1, n), descending=True).values
  return s.contiguous(), w.contiguous()


def to_dev(x, device) -> torch.Tensor:
  return torch.tensor(np.ascontiguousarray(x), dtype=torch.float32,
                      device=device)


def two_ramps(rows: int, n: int) -> np.ndarray:
  """Each row: two strictly decreasing halves, the right one above the
  left.  Every merge level below the top is already solved, and the top
  level pools the whole row into one block, absorbing one block on each
  side per step: the divide-and-conquer PAV's longest serial chain."""
  half = n // 2
  row = np.concatenate([np.linspace(0.0, -1.0, half),
                        np.linspace(2.0, 1.0, n - half)])
  return np.tile(row, (rows, 1))


def pav_inputs(rng, dev, rows: int, n: int, theta_np, tokens_np):
  """The solver inputs of phase 3, on the card, by (kernel, kind): the
  main path's own, a random row, and the adversarial two ramps (kl: as s,
  with w = 0)."""
  if rows == 1:
    s, w = main_solver_inputs(None, to_dev(tokens_np, dev))
  else:
    s, w = main_solver_inputs(to_dev(theta_np[(rows, n)], dev), None)
  _, (rs, rw) = solver_inputs(rng, rows, n, "random")
  rs, rw = to_dev(rs, dev), to_dev(rw, dev)
  ramps = to_dev(two_ramps(rows, n), dev)
  return {("pav_l2", "main"): ((s - w).contiguous(),),
          ("pav_l2", "random"): ((rs - rw).contiguous(),),
          ("pav_l2", "adversarial"): (ramps,),
          ("pav_kl", "main"): (s, w),
          ("pav_kl", "random"): (rs, rw),
          ("pav_kl", "adversarial"): (ramps, torch.zeros_like(ramps))}


# Why pav_kl may differ from pav_kl_scan in the last bit while pav_l2 may
# not: the kl merge is a logaddexp (expf, log1pf), the l2 merge an add.
KL_ON_CARD = ("the kernel's expf / log1pf and those of PyTorch's build "
              "(torch.logaddexp on the card) round an ulp apart")
KL_ON_CPU = ("the plain version ran on the CPU, whose torch.logaddexp "
             "rounds otherwise than the card's")


def hold(kname: str, what: str, out, plain, record, reason=None,
         blocks: bool = True) -> str:
  """``out`` against its plain version: within 1e-5 * (1 + max|plain|),
  bit for bit unless ``reason`` says why an ulp may differ, and (with
  ``blocks``) with the same blocks, which the backward reads from equal
  adjacent outputs.  Returns the line's text."""
  from repro_torch.kernels import segment_vjp
  err = record(kname, out, plain)
  differ = int((out != plain).sum())
  check(differ == 0 or reason is not None,
        f"{kname} {what}: {differ} elements not bit for bit")
  text = (f"max |kernel - plain| {err:.3e} (tol 1e-5 * (1 + max|plain|)), "
          f"{differ} of {out.numel()} elements not bit for bit")
  if differ:
    text += f" (they may: {reason})"
  if blocks:
    nb = [int(segment_vjp.block_starts(v).sum()) for v in (out, plain)]
    check(nb[0] == nb[1], f"{kname} {what}: blocks {nb}")
    text += f"; {nb[0]} blocks in both"
  return text


def plain_on_cpu(fn_name: str, arrays):
  """Worker process: the plain version ``fn_name`` (of ``kernels.pav`` or
  ``kernels.pav_scan``) on a CPU copy of the inputs.  Returns the output
  and the seconds it took."""
  sys.path.insert(0, str(ROOT / "src"))
  from repro_torch.kernels import pav, pav_scan
  torch.set_num_threads(1)
  fn = getattr(pav, fn_name, None) or getattr(pav_scan, fn_name)
  t0 = time.perf_counter()
  with torch.inference_mode():
    out = fn(*map(torch.from_numpy, arrays))
  return out.numpy(), time.perf_counter() - t0


def token_loss_on_cpu(tokens: np.ndarray):
  """Worker process: soft_trimmed_token_loss fwd+bwd with the port's CPU
  backend.  Returns the value, the gradient and the seconds it took."""
  sys.path.insert(0, str(ROOT / "src"))
  import repro_torch as rt
  torch.set_num_threads(1)
  t0 = time.perf_counter()
  x = torch.tensor(tokens, dtype=torch.float32, requires_grad=True)
  out = rt.soft_trimmed_token_loss(x, TRIM_FRACTION, TRIM_EPS)
  (grad,) = torch.autograd.grad(out, x)
  return (out.detach().numpy(), grad.numpy()), time.perf_counter() - t0


def operators(rt):
  """Public entry points of the main path, as ``op(x, target)``."""
  return {
      "soft_rank_l2": lambda x, t: rt.soft_rank(x, EPS, "l2"),
      "soft_rank_kl": lambda x, t: rt.soft_rank(x, EPS, "kl"),
      "soft_sort_l2": lambda x, t: rt.soft_sort(x, EPS, "l2"),
      "soft_sort_kl": lambda x, t: rt.soft_sort(x, EPS, "kl"),
      "soft_spearman_loss": lambda x, t: rt.soft_spearman_loss(x, t, EPS),
      "soft_trimmed_token_loss": lambda x, t: rt.soft_trimmed_token_loss(
          x, TRIM_FRACTION, TRIM_EPS),
  }


def run(op, x_np, t_np, g_np, device):
  """Forward and backward of ``op`` on fresh copies of the inputs."""
  x = to_dev(x_np, device).requires_grad_(True)
  t = None if t_np is None else to_dev(t_np, device)
  out = op(x, t)
  g = to_dev(g_np, device) if out.dim() else torch.ones((), device=device)
  (grad,) = torch.autograd.grad(out, x, g)
  return out.detach(), grad


def card_decision(kind: str, op: str, reg: str, shape,
                  dtype: str = "float32") -> tuple[str, str]:
  """The plan chain's (backend, source) for a query on the card: the
  packaged plan where it has a rule, else the built-in plan."""
  from repro_torch import plan as plan_mod
  backend, source, _, _ = plan_mod.decide(kind, op, reg, platform="cuda",
                                          dtype=dtype, shape=shape)
  return backend, source


def dispatch_counts_wanted(calls: list[tuple[str, tuple[int, ...]]]
                           ) -> dict[str, int]:
  """Every ``dispatch_calls`` / ``dispatch_bwd_calls`` /
  ``projection_fused_calls`` counter that operator calls on the card
  (``calls``: the regularization and the solve's shape of each, f32)
  record: each one projection on the path that the plan chain decides at
  its shape, one solve on the forward backend it decides there, and one
  backward on its backward formulation."""
  want: dict[str, int] = {}

  def bump(key):
    want[key] = want.get(key, 0) + 1

  for reg, shape in calls:
    path, _ = card_decision("projection", "projection", reg, shape)
    fwd, _ = card_decision("forward", "isotonic", reg, shape)
    bwd_op = "projection" if path == "fused" else "isotonic"
    bwd, _ = card_decision("backward", bwd_op, reg, shape)
    bump(f"dispatch_calls{{backend={fwd},op=isotonic,regularization={reg}}}")
    bump(f"dispatch_calls{{backend={path},op=projection,"
         f"regularization={reg}}}")
    bump(f"dispatch_bwd_calls{{backend={bwd},op={bwd_op},"
         f"regularization={reg}}}")
    if path == "fused":
      bump(f"projection_fused_calls{{regularization={reg}}}")
  return want


def kernel_calls(calls: list[tuple[str, tuple[int, ...]]]) -> dict[str, int]:
  """The PAV launches that ``calls`` make: one a solve that the plan
  chain sends to the ``cuda`` backend."""
  out = {"pav_l2": 0, "pav_kl": 0}
  for reg, shape in calls:
    if card_decision("forward", "isotonic", reg, shape)[0] == "cuda":
      out[f"pav_{reg}"] += 1
  return out


def main_path(rt, pav, dev, theta_np, target_np, cot_np, tokens_np):
  """Phase 4: the main path once with counters from 0; returns the
  launches and the (out, grad) of every call.  The PAV launches and the
  dispatch layer's per-call counters (``dispatch_calls``,
  ``dispatch_bwd_calls``, ``projection_fused_calls``) must equal the
  operator calls made, each routed as the plan chain decides at its
  shape."""
  from repro_torch.obs import metrics
  ops = operators(rt)
  solves = []          # (regularization, the solve's shape) a call
  pav.reset_launches()
  metrics.set_enabled(True)
  metrics.reset()
  results = {}
  for shape in SHAPES:
    for opname in OPERATORS:
      results[(opname, shape)] = run(ops[opname], theta_np[shape],
                                     target_np[shape], cot_np[shape], dev)
      solves.append(("kl" if opname.endswith("_kl") else "l2", shape))
  results[("soft_trimmed_token_loss", tokens_np.shape)] = run(
      ops["soft_trimmed_token_loss"], tokens_np, None, None, dev)
  solves.append(("l2", (tokens_np.size,)))
  calls = kernel_calls(solves)
  torch.cuda.synchronize()
  launches = dict(pav.LAUNCHES)
  counted = {k: v for name in ("dispatch_calls", "dispatch_bwd_calls",
                               "projection_fused_calls")
             for k, v in metrics.counters(name + "{").items()}
  shapes = metrics.counters("dispatch_shape{")
  say(f"main: launches {launches}, operator calls {calls}")
  say(f"main: dispatch counters {counted}; {shapes}")
  token_run = results[("soft_trimmed_token_loss", tokens_np.shape)]
  for kname in launches:
    check(launches[kname] > 0, f"{kname} was not launched on the main path")
    check(launches[kname] == calls[kname],
          f"{kname}: {launches[kname]} launches for {calls[kname]} calls")
  want = dispatch_counts_wanted(solves)
  check(counted == want, f"dispatch counters {counted}, for the calls made "
        f"{want}")
  check(sum(shapes.values()) == len(solves),
        f"dispatch_shape {shapes} for {len(solves)} forward calls")

  for (opname, shape), (out, grad) in results.items():
    want = () if opname.endswith("loss") else shape
    check(tuple(out.shape) == want and grad.shape == shape,
          f"{opname} {shape}: shapes {tuple(out.shape)}, {tuple(grad.shape)}")
    check(bool(torch.isfinite(out).all() and torch.isfinite(grad).all()),
          f"{opname} {shape}: non-finite values or gradients")
  token_loss = float(results[("soft_trimmed_token_loss", tokens_np.shape)][0])
  say("main: all outputs and gradients finite, of the expected shapes; "
      f"trimmed token loss {token_loss:.6f}")

  cpu = torch.device("cpu")
  shape = HEADLINE
  for opname in OPERATORS:
    out, grad = results[(opname, shape)]
    ref_out, ref_grad = run(ops[opname], theta_np[shape], target_np[shape],
                            cot_np[shape], cpu)
    e_out, e_grad = close(out, ref_out), close(grad, ref_grad)
    say(f"main: {opname} {shape} card vs CPU port: values {e_out:.3e}, "
        f"gradients {e_grad:.3e} (tol 1e-5 * (1 + max|CPU|))")

  # soft_rank's z = -theta / eps on both devices.  PyTorch's CUDA division
  # by a Python scalar multiplies by the reciprocal rounded to f32; the
  # operators divide by a 0-dim tensor on the card (operators._div_eps), as
  # the CPU divides.
  from repro_torch.core.operators import _div_eps
  theta = to_dev(theta_np[shape], cpu)
  z_op = _div_eps(-theta.to(dev), EPS).cpu()
  z_scalar = ((-theta.to(dev)) / 2.9).cpu()
  z_cpu = (-theta) / EPS
  check(torch.equal(z_op, z_cpu), "the operators' z differs on the card")
  say(f"main: z = -theta/eps {shape}: the operators' division on the card "
      f"equals the CPU's in all {z_cpu.numel()} elements; PyTorch's CUDA "
      f"division by the Python scalar 2.9 differs from the CPU's in "
      f"{int((z_scalar != (-theta) / 2.9).sum())}")
  return launches, token_run


def f64_on_the_card(rt, pav, dev, rng) -> list[str]:
  """Fault F2's check: soft_rank / soft_sort, l2 and kl, on f64 tensors on
  the card (the built-in plan sends them to ``scan``) against the CPU at
  1e-10 * (1 + max|CPU|), values and gradients; no PAV kernel launches."""
  x_np = rng.normal(size=(8, 1000)) * 3
  cot = rng.normal(size=x_np.shape)
  before = dict(pav.LAUNCHES)
  lines = []
  for opname in ("soft_rank", "soft_sort"):
    for reg in ("l2", "kl"):
      res = []
      for device in (dev, torch.device("cpu")):
        x = torch.tensor(x_np, dtype=torch.float64, device=device,
                         requires_grad=True)
        out = getattr(rt, opname)(x, EPS, reg)
        (g,) = torch.autograd.grad(out, x, torch.tensor(cot, device=device))
        check(out.dtype == g.dtype == torch.float64,
              f"f64 {opname} {reg}: dtype {out.dtype}")
        res.append((out.detach(), g))
      e_out = close(res[0][0], res[1][0], rel=1e-10)
      e_grad = close(res[0][1], res[1][1], rel=1e-10)
      lines.append(f"{opname}_{reg} values {e_out:.2e}, gradients "
                   f"{e_grad:.2e}")
  torch.cuda.synchronize()
  check(dict(pav.LAUNCHES) == before, "f64 on the card launched a PAV kernel")
  return lines


# ---------------------------------------------------------------------------
# The execution plan on the card (repro_torch.tools, repro_torch.plan).
# ---------------------------------------------------------------------------

# The smoke sweep's budget for a stack-machine cell: its (8, 1024) cells
# (~0.5 s a call on the card) are skipped with the reason, its n = 64 ones
# run.
PLAN_STACK_BUDGET_S = 2.0
PLAN_CHECK_SHAPE = (8, 1024)
# The main path's solves, by where they come from.
PLAN_SHAPES = (("operators", (128, 1000)), ("operators", (128, 10000)),
               ("router", (4096, 64)), ("router", (2048, 64)),
               ("soft-LTS", (1, 2048)), ("soft-LTS", (1, 4096)),
               ("engine", (32, 4096)), ("main path's token loss", (1, TOKENS)))


def plan_agreement(rt, pav, pav_scan, dev, ran: set[str], record) -> str:
  """At ``PLAN_CHECK_SHAPE``: soft_rank's value and its VJP with a random
  cotangent (the form of the reference's cross-backend tests) by every
  backend that ran there, against the cuda kernel's, within 1e-5 * (1 +
  max|cuda|); the kernels on soft_rank's solver inputs bit for bit their
  plain versions (kl: an ulp, as in phase 3).  Not the sweep's loss,
  sum(r**2): its cotangent 2r is ~n at every position, the block sums of
  the scatter backward round in the order of the card's atomics, and on an
  H100 the l2 gradients of one forward part by ~7e-6 of their size from
  call to call, near the contract."""
  rng = np.random.default_rng([SEED, 28])
  x_np = rng.normal(size=PLAN_CHECK_SHAPE)
  cot = to_dev(rng.normal(size=PLAN_CHECK_SHAPE), dev)
  parts = []
  for reg in ("l2", "kl"):
    res = {}
    for backend in sorted(ran):
      x = to_dev(x_np, dev).requires_grad_(True)
      r = rt.soft_rank(x, EPS, reg, impl=backend)
      (g,) = torch.autograd.grad(r, x, cot)
      res[backend] = (r.detach(), g)
    errs = {b: (close(v, res["cuda"][0]), close(g, res["cuda"][1]))
            for b, (v, g) in res.items() if b != "cuda"}
    parts.append(f"{reg}: " + ", ".join(
        f"{b} values {e[0]:.2e} gradients {e[1]:.2e}"
        for b, e in errs.items()))
  s, w = main_solver_inputs(to_dev(x_np, dev), None)
  for kname, args in (("pav_l2", ((s - w).contiguous(),)),
                      ("pav_kl", (s, w))):
    out = getattr(pav, kname)(*args)
    plain = getattr(pav_scan, f"{kname}_scan")(*args)
    parts.append(f"{kname} on soft_rank's solver input: " + hold(
        kname, f"{PLAN_CHECK_SHAPE} plan phase", out, plain, record,
        KL_ON_CARD if kname == "pav_kl" else None))
  return "; ".join(parts)


def evidence_times(runtime: dict, reg: str, n: int, rows: int) -> str:
  """Each backend's fwd+bwd time in the committed backend sweep at the
  measured cell nearest (rows, n) (log distance), for a line that names a
  shape the packaged plan routes away from the built-in plan."""
  ran = [r for r in runtime["results"]
         if r.get("regularization") == reg and "skipped" not in r]
  cells = {(r["n"], r["batch"]) for r in ran}
  cn, cb = min(cells, key=lambda c: (abs(math.log(c[0] / n)),
                                      abs(math.log(c[1] / rows))))
  return f"nearest cell (n {cn}, batch {cb}): " + ", ".join(
      f"{r['backend']} {r['fwd_bwd_us']:.1f} us" for r in ran
      if (r["n"], r["batch"]) == (cn, cb))


def plan_phase(rt, pav, pav_scan, dev, record, name_limit) -> list[str]:
  """The "plan" phase: the smoke tier of both sweeps on the card, every
  row finite or skipped with its reason and every backend that ran at
  ``PLAN_CHECK_SHAPE`` held to the kernel; a plan derived from them and
  check 5 on it; checks 1, 2, 3 and 5 on the committed plan and its
  evidence; the packaged plan's decisions at the main path's shapes beside
  the built-in plan's (an f64 solve must go to ``scan``)."""
  from repro_torch import plan as plan_mod
  from repro_torch.obs import artifacts
  from repro_torch.tools import autotune, check_backends as cb, sweeps
  t0 = time.perf_counter()
  lines = []
  with tempfile.TemporaryDirectory() as tmp:
    runtime_path = str(Path(tmp) / "runtime.json")
    projection_path = str(Path(tmp) / "projection.json")
    runtime = sweeps.run_backend_sweep(
        smoke=True, out_path=runtime_path, device=dev,
        stack_budget_s=PLAN_STACK_BUDGET_S)
    projection = sweeps.run_projection(smoke=True,
                                       out_path=projection_path, device=dev)
    for path in (runtime_path, projection_path):
      errors = artifacts.validate_file(path)
      check(not errors, f"plan: the smoke sweep's artifact: {errors}")
    rows = runtime["results"] + projection["results"]
    skipped = [r for r in rows if "skipped" in r]
    check(all(r["skipped"] for r in skipped), "plan: a skip without reason")
    check(not [r for r in skipped if r["backend"] == "cuda"],
          "plan: a cuda row was skipped on the card")
    ran_at = {r["backend"] for r in runtime["results"]
              if "skipped" not in r
              and (r["batch"], r["n"]) == PLAN_CHECK_SHAPE}
    check("cuda" in ran_at, f"plan: cuda did not run at {PLAN_CHECK_SHAPE}")
    lines.append(
        f"plan: smoke sweeps on the card: {len(rows)} rows, "
        f"{len(skipped)} skipped (" + "; ".join(sorted(
            {f"{r['backend']}: {r['skipped']}" for r in skipped})[:4])
        + f"), the rest finite; at {PLAN_CHECK_SHAPE} against cuda: "
        + plan_agreement(rt, pav, pav_scan, dev, ran_at, record))
    derived = autotune.build_plan(runtime, projection)
    derived_path = str(Path(tmp) / "plan.json")
    derived.save(derived_path)
    problems = cb.check_plan(derived_path, [runtime_path, projection_path])
    check(not problems, f"plan: check 5 on the smoke plan: {problems}")
    lines.append(f"plan: derived from the smoke sweeps: {len(derived.rules)}"
                 f" rules ({', '.join(sorted({r.backend for r in derived.rules}))}),"
                 f" hash {derived.plan_hash()}; check 5 passes")

  problems = (cb.check_docs_coverage()
              + cb.check_bench_artifact(autotune.DEFAULT_BENCH)
              + cb.check_projection_artifact(autotune.DEFAULT_BENCH_PROJECTION)
              + cb.check_plan(plan_mod.DEFAULT_PLAN_PATH,
                              [autotune.DEFAULT_BENCH,
                               autotune.DEFAULT_BENCH_PROJECTION]))
  check(not problems, f"plan: checks on the committed plan: {problems}")
  packaged = plan_mod.default_plan()
  check(packaged is not None, "plan: no packaged plan loaded")
  # The engine holds each result bit for bit to the unpadded call, which
  # resolves at (1, n) where its cell resolved at (rows, bucket).
  check(all(r.min_rows is None and r.max_rows is None
            for r in packaged.rules),
        "plan: a rule bounds rows; the engine's bitwise check would compare "
        "two backends")
  lines.append(f"plan: the packaged plan {packaged.name} hash "
               f"{packaged.plan_hash()}, {len(packaged.rules)} rules; checks "
               "1, 2, 3 and 5 pass on it and its evidence")

  with open(autotune.DEFAULT_BENCH, encoding="utf-8") as f:
    evidence = json.load(f)
  decisions, moved = [], []
  for what, shape in PLAN_SHAPES:
    for reg in ("l2", "kl"):
      backend, source = card_decision("forward", "isotonic", reg, shape)
      builtin = plan_mod.builtin_plan().decide(
          "forward", "isotonic", reg, platform="cuda", dtype="float32",
          shape=shape).backend
      decisions.append(f"{what} {shape} {reg} -> {backend} ({source})")
      if backend != builtin:
        moved.append(f"{what} {shape} {reg}: {backend} (packaged) against "
                     f"{builtin} (built-in); {evidence_times(evidence, reg, shape[-1], math.prod(shape[:-1]))}")
  for kind, op in (("backward", "projection"), ("projection", "projection")):
    backend, source = card_decision(kind, op, "l2", (128, 1000))
    decisions.append(f"{kind} (128, 1000) -> {backend} ({source})")
  f64, f64_source = card_decision("forward", "isotonic", "l2", (128, 1000),
                                  dtype="float64")
  check(f64 == "scan", f"plan: an f64 solve on the card goes to {f64}")
  decisions.append(f"f64 (128, 1000) -> {f64} ({f64_source})")
  lines.append("plan: decisions on the card: " + "; ".join(decisions))
  lines.append("plan: shapes the packaged plan routes away from the "
               "built-in plan: " + ("; ".join(moved) if moved else "none"))
  lines.append(f"plan: the phase took {time.perf_counter() - t0:.1f} s "
               f"[{name_limit}]")
  return lines


# ---------------------------------------------------------------------------
# The soft-op serving engine (repro_torch.serving).
# ---------------------------------------------------------------------------

ENGINE_REQUESTS, ENGINE_SEED = 500, 0
# The n at which the engine's buckets (64, 128, ..., 4096) change.
ENGINE_EDGES = (64, 65, 2048, 2049, 4096)


def engine_all_ops() -> tuple[str, ...]:
  """The 12 kl and l2 serving ops that are descending or have no
  direction."""
  from repro_torch.serving import SERVING_OPS
  return tuple(k for k in sorted(SERVING_OPS) if not k.endswith("/asc"))


def engine_unpadded(rt, req, device) -> torch.Tensor:
  """The unpadded port call that one engine request stands for."""
  x = torch.from_numpy(np.asarray(req.values)).to(device)
  op, reg = req.op.split("/")[:2]
  extra = req.extras
  if op == "soft_sort":
    return rt.soft_sort(x, req.eps, reg)
  if op == "soft_rank":
    return rt.soft_rank(x, req.eps, reg)
  if op == "soft_topk":
    return rt.soft_topk_mask(x, extra["k"], req.eps, reg)
  if op == "projection":
    return rt.projection_permutahedron(
        x, torch.from_numpy(extra["w"]).to(device), reg)
  if op == "spearman":
    return rt.soft_spearman_loss(
        x, torch.from_numpy(extra["target"]).to(device), req.eps, reg,
        direction="DESCENDING")
  return rt.soft_lts_loss(x, extra["trim"], req.eps, reg)


def engine_on_cpu(ops, lo: int, hi: int):
  """Worker process: requests lo..hi of the engine's stream over ``ops``,
  each as its unpadded port call on the CPU (the stack machine).  Returns
  the results and the seconds it took."""
  sys.path.insert(0, str(ROOT / "src"))
  import repro_torch as rt
  from repro_torch.serving import synthetic_stream
  torch.set_num_threads(1)
  t0 = time.perf_counter()
  reqs = synthetic_stream(ENGINE_REQUESTS, seed=ENGINE_SEED, ops=ops)[lo:hi]
  with torch.inference_mode():
    out = [engine_unpadded(rt, r, torch.device("cpu")).numpy() for r in reqs]
  return out, time.perf_counter() - t0


def engine_cpu_jobs(pool):
  """Both streams' CPU comparisons, in halves, on the CPU workers."""
  from repro_torch.serving.engine import EngineConfig
  half = ENGINE_REQUESTS // 2
  return {name: [pool.submit(engine_on_cpu, ops, lo, lo + half)
                 for lo in (0, half)]
          for name, ops in (("default", EngineConfig().ops),
                            ("all ops", engine_all_ops()))}


def engine_run_checks(name, rt, dev, engine, requests, results, cells,
                      launches, metrics) -> dict:
  """One stream's checks on the card: no shed and no error, no cell built
  on the request path, every cell on the plan chain's backend, one solve a
  batch and a warmed cell and a PAV launch a cuda solve, and every vector
  result bit for bit the unpadded port call on the card (scalars within
  1e-5 * (1 + |card|))."""
  from repro_torch.serving import SERVING_OPS, STATUS_ERROR, STATUS_OK
  statuses = [r.status for r in results]
  check(STATUS_ERROR not in statuses,
        f"engine {name}: {statuses.count(STATUS_ERROR)} errors: "
        f"{next((r.detail for r in results if r.status == STATUS_ERROR), '')}")
  check(not metrics.counters("serving_error"),
        f"engine {name}: {metrics.counters('serving_error')}")
  check(statuses.count(STATUS_OK) == len(requests),
        f"engine {name}: {len(requests) - statuses.count(STATUS_OK)} shed")
  misses = metrics.counter_value("aot_cache_miss")
  check(misses == 0, f"engine {name}: aot_cache_miss {misses} after warm-up")
  keys = engine.cache.keys()
  check(len(keys) == cells, f"engine {name}: {len(keys)} cells, {cells} warmed")
  # Every cell on the backend the plan chain decides at its (rows, bucket).
  planned = {k: card_decision("forward", "isotonic",
                              SERVING_OPS[k[0]].regularization,
                              (k[2], k[3]))[0] for k in keys}
  off = [k for k in keys if k[1] != planned[k]]
  check(not off, f"engine {name}: cells {off[:3]} not on the plan's backend")
  backends = sorted({k[1] for k in keys})
  cells_by = {"l2": 0, "kl": 0}
  for k in keys:
    cells_by[SERVING_OPS[k[0]].regularization] += 1
  batches = {reg: sum(v for key, v in metrics.counters(
      "serving_batch_exec").items() if f"regularization={reg}" in key)
      for reg in ("l2", "kl")}
  # The dispatch layer's counters: a solve a batch and a warmed cell, a
  # cuda solve a launch.
  solves = {kname: metrics.counter_value(
      "dispatch_calls", op="isotonic", regularization=reg, backend="cuda")
      for reg, kname in (("l2", "pav_l2"), ("kl", "pav_kl"))}
  for reg, kname in (("l2", "pav_l2"), ("kl", "pav_kl")):
    want = cells_by[reg] + batches[reg]
    every = sum(v for key, v in metrics.counters("dispatch_calls{").items()
                if f"op=isotonic,regularization={reg}}}" in key)
    check(every == want, f"engine {name}: {every} {reg} solves for "
          f"{batches[reg]} batches + {cells_by[reg]} warm-up cells")
    if backends == ["cuda"]:
      check(launches[kname] == want,
            f"engine {name}: {kname} {launches[kname]} launches for "
            f"{batches[reg]} batches + {cells_by[reg]} warm-up cells")
  check(all(solves[k] == launches[k] for k in solves),
        f"engine {name}: dispatch_calls of the cuda solves {solves}, "
        f"launches {launches}")
  for kname in ("soft_topk_gates", "flash_attention",
                "flash_attention_simt"):
    check(launches[kname] == 0,
          f"engine {name}: {kname} {launches[kname]} launches")
  say(f"engine: {name}: launches {launches} = executed batches {batches} + "
      f"warm-up cells {cells_by} on the cuda cells; 0 shed, 0 errors, "
      f"aot_cache_miss 0; every cell on the plan chain's backend "
      f"({', '.join(backends)})")
  total = {c: sum(metrics.counters(c + "{").values())
           for c in ("dispatch_resolve", "dispatch_calls", "dispatch_shape",
                     "dispatch_bwd_calls", "projection_fused_calls",
                     "projection_resolve")}
  say(f"engine: {name}: counters summed over labels {total}; cuda solves "
      f"by dispatch_calls {solves} = the launches; dispatch_shape "
      f"{metrics.counters('dispatch_shape{')}")
  differ, worst = 0, 0.0
  for req, res in zip(requests, results):
    want = engine_unpadded(rt, req, dev)
    if SERVING_OPS[req.op].output == "vector":
      differ += int(not np.array_equal(res.value, want.cpu().numpy()))
    else:
      err = abs(res.value - float(want))
      worst = max(worst, err / (1.0 + abs(float(want))))
  check(differ == 0, f"engine {name}: {differ} vector results not bit for "
        "bit the unpadded call on the card")
  check(worst <= 1e-5, f"engine {name}: scalar results {worst:.3e} off")
  say(f"engine: {name}: every vector result of {len(requests)} bit for bit "
      "the unpadded port call on the card; scalar results within "
      f"{worst:.2e} * (1 + |card|)")
  return {"results": results, "batches": batches, "launches": launches}


def engine_edges(rt, dev, rng) -> None:
  """Padding at the buckets' edges on the card: each vector op (l2 and kl)
  on one padded row of n = 64, 65, 2048, 2049 and 4096, and at each n-edge
  that the plan chain splices into the ladder and one past it, random and
  with ties, bit for bit the unpadded call."""
  from repro_torch import plan as plan_mod
  from repro_torch.serving import Request
  from repro_torch.serving.bucketing import BucketPolicy
  from repro_torch.serving.ops import SERVING_OPS, bound_op
  policy = BucketPolicy.from_plan(None, min_n=64, max_n=4096, max_batch=1)
  spliced = [e for e in plan_mod.shape_breakpoints() if 64 <= e < 4096]
  sizes = sorted(set(ENGINE_EDGES) | set(spliced)
                 | {e + 1 for e in spliced})
  keys = [k for k in engine_all_ops() if SERVING_OPS[k].output == "vector"]
  checked = 0
  for n in sizes:
    bucket = policy.bucket_for(n)
    for kind in ("random", "ties"):
      v = rng.normal(size=n).astype(np.float32) * 3
      if kind == "ties":
        v = np.round(v) / 2
      w = np.abs(rng.normal(size=n)).astype(np.float32) + 0.1
      for key in keys:
        extras = {"k": max(1, n // 5), "w": w}
        req = Request(op=key, values=v, eps=0.3, extras=extras)
        row = np.zeros((1, bucket), np.float32)
        row[0, :n] = v
        args = [torch.from_numpy(row), torch.tensor([n]),
                torch.tensor([0.3], dtype=torch.float32)]
        if key.startswith("soft_topk"):
          args.append(torch.tensor([extras["k"]]))
        elif key.startswith("projection"):
          wr = np.zeros((1, bucket), np.float32)
          wr[0, :n] = w
          args.append(torch.from_numpy(wr))
        with torch.inference_mode():
          got = bound_op(key)(*[a.to(dev) for a in args])[0, :n]
          want = engine_unpadded(rt, req, dev)
        check(torch.equal(got, want),
              f"engine: {key} n {n} {kind}: padded differs from unpadded "
              f"by {float((got - want).abs().max()):.3e}")
        checked += 1
  say(f"engine: {checked} padded rows at n = {tuple(sizes)} (random and "
      "ties, every vector op, l2 and kl; buckets "
      f"{policy.sizes}) bit for bit the unpadded call on the card")


def engine_path(rt, dev, serve, kops, rng) -> dict:
  """The engine phase: ``launch/serve.py --engine`` with the reference's
  defaults, then a stream over all 12 desc / undirected ops, each with
  every kernel's launch count from 0, then their checks, the bucket edges
  and the artifact."""
  from repro_torch.obs import artifacts, metrics
  from repro_torch.serving import EngineConfig, ServingEngine, \
      synthetic_stream
  metrics.set_enabled(True)
  runs = {}
  with tempfile.TemporaryDirectory() as tmp:
    bench = str(Path(tmp) / "BENCH_engine.json")
    metrics.reset()
    kops.reset_all_launches()
    res = serve.main(["--engine", "--bench-json", bench])
    torch.cuda.synchronize()
    launches = kops.all_launches()
    errors = artifacts.validate_file(bench)
    check(not errors, f"engine: the BENCH artifact is invalid: {errors}")
    with open(bench) as f:
      payload = json.load(f)
  check(res["engine"].device == dev, f"engine ran on {res['engine'].device}")
  runs["default"] = engine_run_checks(
      "default stream", rt, dev, res["engine"], res["requests"],
      res["results"], res["warm_cells"], launches, metrics)
  runs["default"]["summary"] = res
  say(f"engine: BENCH artifact valid (repro_torch.obs.artifacts), "
      f"{len(payload['results'])} result, plan "
      f"{payload['meta']['plan_name']} {payload['meta']['plan_hash']}, "
      f"platform {payload['meta']['platform']}")

  ops = engine_all_ops()
  metrics.reset()
  kops.reset_all_launches()
  engine = ServingEngine(EngineConfig(ops=ops, max_batch=32,
                                      aot_capacity=1024))
  t0 = time.perf_counter()
  cells = engine.warmup()
  warm_s = time.perf_counter() - t0
  requests = synthetic_stream(ENGINE_REQUESTS, seed=ENGINE_SEED, ops=ops)
  t0 = time.perf_counter()
  results = engine.serve(requests)
  wall = time.perf_counter() - t0
  torch.cuda.synchronize()
  launches = kops.all_launches()
  say(f"engine: all {len(ops)} ops: warmed {cells} cells in {warm_s:.2f} s;"
      f" served {len(results)} in {wall:.3f} s "
      f"({len(results) / wall:.0f} req/s), CPU workers busy")
  runs["all ops"] = engine_run_checks(
      f"all {len(ops)} ops", rt, dev, engine, requests, results, cells,
      launches, metrics)
  engine_edges(rt, dev, rng)
  return runs


def engine_cpu_checks(runs, futures) -> None:
  """Every engine result within 1e-5 * (1 + max|CPU|) of the unpadded
  port call on the CPU (the workers' results)."""
  for name, futs in futures.items():
    want, seconds = [], 0.0
    for fut in futs:
      out, sec = fut.result()
      want += out
      seconds += sec
    worst = 0.0
    for res, ref in zip(runs[name]["results"], want):
      got = torch.as_tensor(np.asarray(res.value, np.float32))
      worst = max(worst, close(got.reshape(np.shape(ref)),
                               torch.from_numpy(np.asarray(ref))))
    say(f"engine: {name}: every result within 1e-5 * (1 + max|CPU|) of "
        f"the unpadded port call on the CPU (worst |diff| {worst:.3e}; "
        f"CPU {seconds:.1f} s)")


ENGINE_TIMED_RUNS = 3
ENGINE_KERNEL_SHAPE = (32, 4096)   # max batch x largest bucket
# The Lemma 2 backward's shapes: the train step's router rows, its soft-LTS
# row, and the operators' shapes.
BACKWARD_SHAPES = ((2048, 64), (1, 2048), (128, 1000), (128, 10000))


def engine_times(serve, pav, pav_scan, segment_vjp, dev, rng, record,
                 name_limit):
  """Phase 5, engine: the default stream again, after the CPU workers
  (warm-up seconds, req/s, latency percentiles, occupancy, padding waste),
  and the PAV kernels at the engine's largest cell (32, 4096) beside their
  plain versions (held to them, as in phase 3) and bounds."""
  lines, rows = [], {}
  for i in range(ENGINE_TIMED_RUNS):
    r = serve.main(["--engine"])
    lines.append(
        f"times: engine default stream, run {i + 1}: warm-up "
        f"{r['warm_cells']} cells {r['warm_s']:.3f} s; {r['ok']} served, "
        f"{r['shed']} shed in {r['wall_s'] * 1e3:.1f} ms = "
        f"{r['req_per_s']:.0f} req/s; p50/p95/p99 latency "
        f"{r['p50_us']:.0f}/{r['p95_us']:.0f}/{r['p99_us']:.0f} us; mean "
        f"batch occupancy {r['occupancy_pct']:.1f}%, padding waste "
        f"{r['padding_waste_pct']:.1f}%; aot_cache_miss {r['aot_cache_miss']}"
        f" [{name_limit}]")
  rows_n = ENGINE_KERNEL_SHAPE
  theta = to_dev(rng.normal(size=rows_n), dev)
  s, w = main_solver_inputs(theta, None)
  for kname, args in (("pav_l2", ((s - w).contiguous(),)),
                      ("pav_kl", (s, w))):
    kernel = getattr(pav, kname)
    out = kernel(*args)
    blocks = int(segment_vjp.block_starts(out).sum())
    push, merge, block = OPS[kname]
    n_el = rows_n[0] * rows_n[1]
    n_ops = n_el * push + (n_el - blocks) * merge + blocks * block
    bytes_ms = n_el * BYTES_PER_ELEM[kname] / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_OPS_PER_S * 1e3
    ms = median_ms(lambda: kernel(*args), 20)
    dev_ms = kernel_device_ms(lambda: kernel(*args), DEVICE_NAMES[kname], 20,
                              max(bytes_ms, ops_ms),
                              pav.kernels_a_call(*rows_n))
    plain = getattr(pav_scan, f"{kname}_scan")
    plain_ms = median_ms(lambda: plain(*args), 3)
    held = hold(kname, f"{rows_n} soft_rank input", out, plain(*args),
                record, KL_ON_CARD if kname == "pav_kl" else None)
    rows[kname] = {"engine_ms": ms, "engine_device_ms": dev_ms}
    lines.append(
        f"times: {kname} {rows_n} (the engine's largest cell, soft_rank "
        f"input) kernel {ms:.4f} ms (device {ms_text(dev_ms)}, profiler), "
        f"plain {plain_ms:.2f} ms, bound {max(bytes_ms, ops_ms):.5f} ms "
        f"({'bytes' if bytes_ms >= ops_ms else 'operations'}), {blocks} "
        f"blocks; {held} [{name_limit}]")
  return rows, lines


def backward_times(pav, dispatch, dev, rng, name_limit):
  """Phase 5: the two Lemma 2 backwards of the fused projection,
  ``segscan`` and ``scatter``, at the train step's and the operators'
  shapes (CUDA-event medians), held to each other within 1e-5 * (1 +
  max|scatter|); the plan chain's cuda backward rule (the packaged
  plan's) must be the faster one wherever one is faster by a quarter or
  more."""
  from repro_torch import plan as plan_mod
  from repro_torch.kernels import segment_vjp
  lines, slower = [], []
  for rows, n in BACKWARD_SHAPES:
    y = to_dev(rng.normal(size=(rows, n)), dev)
    v = pav.pav_l2(y)
    starts = segment_vjp.block_starts(v)
    g = to_dev(rng.normal(size=(rows, n)), dev)
    s_kl = torch.sort(to_dev(rng.normal(size=(rows, n)), dev),
                      descending=True).values
    w_kl = to_dev(rng.normal(size=(rows, n)), dev)
    regs = ("l2",) if rows in (2048, 1) else ("l2", "kl")
    for reg in regs:
      args = ((g, starts) if reg == "l2" else (s_kl, w_kl, g, starts))
      outs, times = {}, {}
      for b in ("segscan", "scatter"):
        fn = lambda b=b: dispatch.dispatch_backward("projection", reg, b,
                                                    *args)
        outs[b] = fn()
        times[b] = median_ms(fn, 20)
      for a, c in zip(*(o if isinstance(o, tuple) else (o,)
                        for o in (outs["segscan"], outs["scatter"]))):
        close(a, c)
      ratio = times["segscan"] / times["scatter"]
      slower.append(ratio)
      lines.append(f"times: projection backward {reg} ({rows}, {n}): "
                   f"segscan {times['segscan']:.4f} ms, scatter "
                   f"{times['scatter']:.4f} ms (segscan / scatter "
                   f"{ratio:.2f}) [{name_limit}]")
  rule, source, _ = plan_mod.resolve_via_plans(
      "backward", "projection", "l2", platform="cuda", dtype="float32",
      shape=(128, 1000))
  decisive = [r for r in slower if r >= 1.25 or r <= 0.8]
  faster = "scatter" if sum(r > 1 for r in decisive) > len(decisive) / 2 \
      else "segscan"
  if decisive:
    check(rule == faster, f"the plan chain's cuda backward rule ({source}) "
          f"is {rule}, but {faster} is faster at {len(decisive)} of "
          f"{len(slower)} shapes")
  lines.append(f"times: projection backward: segscan / scatter "
               f"{min(slower):.2f}-{max(slower):.2f}; the plan chain's "
               f"cuda rule: {rule} ({source}) [{name_limit}]")
  return lines


# ---------------------------------------------------------------------------
# The LM serving path (deepseek-v2-lite-16b) and its kernels.
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Figure 4 (right) of the paper on the card: the O(n log n) operators
# against the O(n^2) baselines of ``core/baselines.py``, with the methods,
# strengths and row count of benchmarks/bench_runtime.py.
# ---------------------------------------------------------------------------

FIG4_ROWS = 128
FIG4_NS = (100, 500, 1000, 2000, 5000, 10000)
OT_ITERS = 50                  # benchmarks/bench_runtime.py's OT_ITERS
ALLPAIRS_TAU, OT_EPS = 0.1, 1e-2
# A run whose reckoned bytes would pass this share of the card's memory is
# skipped and its reckoning printed (the O(n^2) baselines run out of memory
# first: the paper's point).
FIG4_MEMORY_SHARE = 0.9
# The baselines on the card in f32 against the CPU in f64 at (8, 100),
# values and the gradient of sum(r**2), within FIG4_CHECK_TOL * (1 +
# max|CPU|): the CPU's own f32 run is within 3.7e-5 of its f64 (OT's
# gradient at eps 1e-2, 50 iterations, the worst).
FIG4_CHECK_SHAPE = (8, 100)
FIG4_CHECK_TOL = 2e-4
HARD_RANK_THETA = (0.3, -1.2, 2.0, 0.9)     # tests/test_system.py's


def fig4_methods(rt, bl) -> dict:
  return {"soft_rank_l2": lambda t: rt.soft_rank(t, EPS, "l2"),
          "soft_rank_kl": lambda t: rt.soft_rank(t, EPS, "kl"),
          "allpairs": lambda t: bl.allpairs_rank(t, ALLPAIRS_TAU),
          f"ot_sinkhorn_t{OT_ITERS}": lambda t: bl.ot_rank(t, OT_EPS,
                                                           OT_ITERS)}


def value_and_square_grad(fn, x: torch.Tensor):
  """(fn(x), the gradient of sum(fn(x)**2)): the benchmark's backward."""
  x = x.detach().requires_grad_(True)
  r = fn(x)
  return r.detach(), torch.autograd.grad(torch.sum(r**2), x)[0]


def fig4_checks(rt, dev) -> list[str]:
  """Each baseline on the card against the CPU (``FIG4_CHECK_TOL``), and
  the reference's own convergence checks on the card: OT at eps 1e-3 with
  400 iterations within 0.05 of the hard ranks, all-pairs at tau 1e-3
  within 1e-3 (tests/test_system.py)."""
  from repro_torch.core import baselines as bl

  x = np.random.default_rng([SEED, 22]).normal(size=FIG4_CHECK_SHAPE)
  lines = []
  for name, fn in (
      (f"allpairs_rank tau {ALLPAIRS_TAU}",
       lambda t: bl.allpairs_rank(t, ALLPAIRS_TAU)),
      (f"ot_rank eps {OT_EPS} {OT_ITERS} iterations",
       lambda t: bl.ot_rank(t, OT_EPS, OT_ITERS)),
      (f"ot_sort eps {OT_EPS} {OT_ITERS} iterations",
       lambda t: bl.ot_sort(t, OT_EPS, OT_ITERS))):
    got = value_and_square_grad(fn, to_dev(x, dev))
    want = value_and_square_grad(fn, torch.from_numpy(x))
    errs = [close(g, w, FIG4_CHECK_TOL) for g, w in zip(got, want)]
    lines.append(f"fig4: {name} {FIG4_CHECK_SHAPE} on the card (f32) vs the"
                 f" CPU (f64): values {errs[0]:.3e}, gradients of sum(r**2) "
                 f"{errs[1]:.3e} (tol {FIG4_CHECK_TOL} * (1 + max|CPU|))")
  theta = torch.tensor(HARD_RANK_THETA, dtype=torch.float32, device=dev)
  hard = rt.hard_rank(theta, "DESCENDING")
  for name, r, tol in (
      ("ot_rank eps 1e-3 400 iterations",
       bl.ot_rank(theta, epsilon=1e-3, num_iters=400), 0.05),
      ("allpairs_rank tau 1e-3", bl.allpairs_rank(theta, 1e-3), 1e-3)):
    err = float((r - hard).abs().max())
    check(bool(torch.isfinite(r).all()) and err <= tol,
          f"{name} is {err:.3e} off the hard ranks")
    lines.append(f"fig4: {name} on the card reaches the hard ranks "
                 f"{hard.tolist()} within {err:.3e} (tol {tol})")
  return lines


def fig4_times(rt, dev, name_limit) -> list[str]:
  """Each method's forward and forward + backward of sum(r**2) on (128, n)
  f32 rows of N(0, 1) from the seed, CUDA-event medians after a warm-up
  (3 runs where the warm-up took over 100 ms, else 10), and the run's peak
  memory above what was allocated before it.  Before a run its bytes are
  reckoned from the peak of the same method and mode at the largest n that
  ran, scaled by (n / n_ran)^2; a run reckoned past FIG4_MEMORY_SHARE of
  the card's memory is skipped with its reckoning.  An out-of-memory error
  is not caught."""
  from repro_torch.core import baselines as bl

  rng = np.random.default_rng([SEED, 4])
  total = torch.cuda.get_device_properties(dev).total_memory
  methods = fig4_methods(rt, bl)
  ran: dict[tuple[str, str], tuple[int, int]] = {}
  lines = []
  for n in FIG4_NS:
    x = to_dev(rng.normal(size=(FIG4_ROWS, n)), dev)
    for name, fn in methods.items():
      for mode in ("fwd", "fwd+bwd"):
        if mode == "fwd":
          def call(fn=fn):
            with torch.no_grad():
              fn(x)
        else:
          def call(fn=fn):
            value_and_square_grad(fn, x)
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        if (name, mode) in ran:
          n_ran, peak_ran = ran[(name, mode)]
          need = peak_ran * (n / n_ran) ** 2
          if base + need > FIG4_MEMORY_SHARE * total:
            lines.append(
                f"fig4: {name} {mode} ({FIG4_ROWS}, {n}): skipped: needs "
                f"~{need / 2**30:.1f} GiB (peak {peak_ran / 2**30:.3f} GiB at"
                f" n = {n_ran}, times ({n} / {n_ran})^2), above "
                f"{FIG4_MEMORY_SHARE:.0%} of the card's "
                f"{total / 2**30:.1f} GiB [{name_limit}]")
            continue
        torch.cuda.reset_peak_memory_stats(dev)
        first = median_ms(call, 1, warmup=0)
        reps = 3 if first > 100 else 10
        ms = median_ms(call, reps, warmup=0)
        peak = torch.cuda.max_memory_allocated(dev) - base
        ran[(name, mode)] = (n, peak)
        lines.append(f"fig4: {name} {mode} ({FIG4_ROWS}, {n}): {ms:.4f} ms "
                     f"(median of {reps} after a warm-up of {first:.2f} ms),"
                     f" peak {peak / 2**30:.3f} GiB [{name_limit}]")
  return lines


def gates_inputs(rng, rows: int, e: int, kind: str) -> np.ndarray:
  """Router logits: N(0, 1), ties on a grid of 0.5, or constant rows."""
  x = rng.normal(size=(rows, e))
  if kind == "ties":
    x = np.round(x * 2) / 2
  elif kind == "constant":
    x[:] = 0.75
  return x


# The attention kernel against its plain version in phase 3: (B, S, H,
# Hkv, D, Dv, causal).  MLA's widths (192, 128) at the deepseek prefill
# shape, GQA, a ragged S and non-causal; the dense width (64, 64) at the
# llama prefill shape (G 4), tinyllama's kv heads (G 8), ragged S (333 is
# a multiple of neither 32 nor 16 positions a block) at both G, G 3 (a G
# that does not divide the 128-row tile: 42 positions, 126 rows) and
# non-causal; grok-1's width (128, 128) at its prefill shape (G 6: 21
# positions, 126 rows), a ragged S and non-causal.
ATTN_CHECK_SHAPES = (
    (SERVE_BATCH, SERVE_PROMPT, 16, 16, 192, 128, True),
    (2, 512, 16, 4, 192, 128, True), (3, 333, 16, 16, 192, 128, True),
    (2, 200, 16, 4, 192, 128, False),
    (SERVE_BATCH, SERVE_PROMPT, 32, 8, 64, 64, True),
    (2, 512, 32, 4, 64, 64, True), (3, 333, 32, 8, 64, 64, True),
    (3, 333, 32, 4, 64, 64, True), (3, 333, 24, 8, 64, 64, True),
    (2, 200, 32, 8, 64, 64, False),
    (SERVE_BATCH, SERVE_PROMPT, 48, 8, 128, 128, True),
    (3, 333, 48, 8, 128, 128, True), (2, 200, 48, 8, 128, 128, False))


# gemma3-12b's width (256, 256) at G 2 in phase 3: (B, Sq, Skv, H, Hkv,
# causal, window).  The serving prefill's two shapes (8 x 2048, causal, and
# the local layers' window 1024); ragged S; a window that is no multiple of
# the 64-key tile (100); a window of one key; a window at least Skv, which
# must give the causal output bit for bit; ragged Sq and Skv, not causal.
GEMMA_ATTN_CASES = (
    (8, 2048, 2048, 16, 8, True, 0), (8, 2048, 2048, 16, 8, True, 1024),
    (3, 333, 333, 16, 8, True, 0), (2, 333, 333, 16, 8, True, 100),
    (2, 333, 333, 16, 8, True, 1), (2, 333, 333, 16, 8, True, 4096),
    (2, 300, 450, 16, 8, True, 100), (2, 77, 130, 16, 8, False, 0))
# recurrentgemma-2b's local layers at (256, 256), G 10 (10 query heads over
# one kv head: 12 positions, 120 of the tile's 128 rows), same fields: its
# serving prefill (8 x 4096 under the window of 2048) and causal; a window
# of one key; a window past Skv (bit for bit the causal output); an Sq that
# is no multiple of 12 (301) under a window that binds; ragged Sq and Skv,
# not causal.
RG_ATTN_CASES = (
    (8, 4096, 4096, 10, 1, True, 2048), (2, 4096, 4096, 10, 1, True, 0),
    (2, 301, 301, 10, 1, True, 1), (2, 301, 301, 10, 1, True, 4096),
    (2, 301, 301, 10, 1, True, 100), (1, 77, 130, 10, 1, False, 0))
# stablelm-3b's width (80, 80) at G 1 (run padded to 128 columns inside the
# kernel), same fields: its serving prefill (8 x 512) and training
# microbatch (1 x 2048), causal; not causal; Sq != Skv; a ragged S (333).
STABLELM_ATTN_CASES = (
    (8, 512, 512, 32, 32, True, 0), (1, 2048, 2048, 32, 32, True, 0),
    (2, 512, 512, 32, 32, False, 0), (2, 300, 450, 32, 32, True, 0),
    (3, 333, 333, 32, 32, True, 0), (2, 77, 130, 32, 32, False, 0))
# llava-next-mistral-7b's layers at (128, 128), G 4 (32 query heads over 8
# kv heads: 32 positions a tile), same fields: its serving prefill (8 x
# 1088: 576 patches and 512 tokens) and training microbatch (1 x 2048),
# causal; a ragged S; Sq != Skv; not causal.
LLAVA_ATTN_CASES = (
    (8, 1088, 1088, 32, 8, True, 0), (1, 2048, 2048, 32, 8, True, 0),
    (3, 333, 333, 32, 8, True, 0), (2, 300, 450, 32, 8, True, 0),
    (2, 77, 130, 32, 8, False, 0))
# musicgen-large's layers at (64, 64), G 1 (32 heads over 32 kv heads, a G
# this width had not run), same fields: its serving prefill (8 x 512) and
# training microbatch (1 x 2048), causal; a ragged S; not causal.
MUSICGEN_ATTN_CASES = (
    (8, 512, 512, 32, 32, True, 0), (1, 2048, 2048, 32, 32, True, 0),
    (3, 333, 333, 32, 32, True, 0), (2, 512, 512, 32, 32, False, 0),
    (2, 77, 130, 32, 32, False, 0))
# tinyllama-1.1b's layers at (64, 64), G 8 (32 query heads over 4 kv
# heads: 16 positions a tile), same fields: its serving prefill (8 x 512)
# and training microbatch (2 x 2048), causal; the prompt and the generated
# tokens together (544); a ragged S (333: 20 tiles and 13 positions);
# Sq != Skv; not causal.
TINYLLAMA_ATTN_CASES = (
    (8, 512, 512, 32, 4, True, 0), (2, 2048, 2048, 32, 4, True, 0),
    (2, 544, 544, 32, 4, True, 0), (3, 333, 333, 32, 4, True, 0),
    (2, 300, 450, 32, 4, True, 0), (2, 77, 130, 32, 4, False, 0))


# The options of the reference's attention that no model path of the port
# uses, at (64, 64) (G 4), (128, 128) (G 6) and (256, 256) (G 2), forward
# and backward in phase 3: (D = Dv, B, Sq, Skv, H, Hkv, causal, window,
# softcap, q_offset).  At each width a soft-cap of 30 (grok's logit cap)
# alone, queries that continue a cache (q_offset = Skv - Sq), a window
# without ``causal`` (the causal windowed kernel), and all three with a
# ragged Sq.
OPTION_ATTN_CASES = tuple(
    (width, b, sq, skv, h, hkv, causal, window, softcap, q_offset)
    for width, h, hkv in ((64, 32, 8), (128, 48, 8), (256, 16, 8))
    for b, sq, skv, causal, window, softcap, q_offset in (
        (2, 512, 512, True, 0, 30.0, 0),
        (2, 300, 812, True, 0, 0.0, 512),
        (2, 512, 512, False, 100, 0.0, 0),
        (2, 333, 777, False, 200, 30.0, 444)))
# q's scale under a soft-cap: scores of ~N(0, 10^2), so that 30 * tanh(s /
# 30) departs from s.
HOT_Q = 10.0


def attn_key(q: torch.Tensor, v: torch.Tensor) -> str:
  """The attention kernel's record name by width: MLA's keeps the plain
  name, a dense width is "flash_attention 64x64" or "... 128x128"."""
  return ("flash_attention" if q.shape[-1] != v.shape[-1]
          else f"flash_attention {v.shape[-1]}x{v.shape[-1]}")


def attn_close(out: torch.Tensor, q, k, v, causal: bool, fa,
               window: int = 0) -> dict:
  """The kernel's output against the plain version in f32 on the same
  bf16 inputs and window, by its error model (``fa.compare_with_plain``):
  every element within 2 * 2**-8 * (|ref| + A), A the attention over |v|
  (tol_ratio <= 1), and ||out - ref||_F <= REL_FROB_LIMIT * ||ref||_F."""
  cmp = fa.compare_with_plain(out, q, k, v, causal, window)
  check(cmp["finite"], "attention: non-finite output")
  check(cmp["tol_ratio"] <= 1.0 and cmp["rel_frob"] <= fa.REL_FROB_LIMIT,
        f"attention: {attn_text(cmp, fa)}")
  return cmp


def attn_text(cmp: dict, fa, diff: str = "kernel - plain in f32") -> str:
  return (f"max |{diff}| {cmp['max_abs_err']:.3e}, worst "
          f"|err| / tol {cmp['tol_ratio']:.3f} (limit 1; tol = 2**-7 * (|ref|"
          f" + A)), relative Frobenius error {cmp['rel_frob']:.3e} (limit "
          f"{fa.REL_FROB_LIMIT:.3e}), median |ref| {cmp['median_ref']:.3e}")


def serve_kernel_checks(rng, dev, st, fa, record, max_err) -> None:
  """Phase 3, serving kernels: each against its plain version on the card
  (the gates bit for bit)."""
  for rows, e, kind, k, eps in ((4096, 64, "random", 6, 1.0),
                                (4096, 64, "ties", 6, 1.0),
                                (4096, 64, "constant", 6, 1.0),
                                (8, 64, "random", 6, 1.0),
                                (8, 64, "ties", 6, 1.0),
                                (333, 100, "random", 6, 1.0),
                                (4096, 64, "random", 6, 0.3),
                                (8, 64, "ties", 6, 0.3),
                                (4096, 64, "random", 6, 1e-2),
                                (8, 64, "ties", 6, 1e-2),
                                (333, 100, "ties", 0, 1.0),
                                (333, 100, "ties", 1, 1.0),
                                (333, 100, "random", 100, 1.0),
                                (333, 128, "ties", 6, 1.0),
                                (333, 20, "ties", 6, 1.0),
                                (4096, 8, "random", 2, 1.0),
                                (4096, 8, "ties", 2, 1.0),
                                (4096, 8, "constant", 2, 1.0),
                                (8, 8, "random", 2, 1.0),
                                (8, 8, "ties", 2, 1.0),
                                (8, 8, "constant", 2, 1.0)):
    x = to_dev(gates_inputs(rng, rows, e, kind), dev)
    out = st.soft_topk_gates(x, k, eps)
    plain = st.soft_topk_gates_plain(x, k, eps)
    text = hold("soft_topk_gates", f"({rows}, {e}) k {k} eps {eps} {kind}",
                out, plain, record, blocks=False)
    sums = float((out.sum(-1) - k).abs().max())
    check(sums <= 1e-4, f"gates row sums off k by {sums:.3e}")
    say(f"kernels: soft_topk_gates ({rows}, {e}) k {k} eps {eps} {kind}: "
        f"{text}; row sums within {sums:.1e} of k")
  for b, s, h, hkv, d, dv, causal in ATTN_CHECK_SHAPES:
    gen = torch.Generator(device=dev).manual_seed(s)
    q, k = (torch.randn((b, s, n, d), generator=gen, device=dev,
                        dtype=torch.bfloat16) for n in (h, hkv))
    v = torch.randn((b, s, hkv, dv), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    cmp = attn_close(fa.flash_attention(q, k, v, causal), q, k, v, causal,
                     fa)
    key = attn_key(q, v)
    max_err[key] = max(max_err[key], cmp["max_abs_err"])
    say(f"kernels: flash_attention q ({b}, {s}, {h}, {d}) v width {dv} kv "
        f"heads {hkv} (G {h // hkv}) causal {causal}: {attn_text(cmp, fa)}")
  for width, cases, key in (
      (256, GEMMA_ATTN_CASES, "flash_attention 256x256"),
      (256, RG_ATTN_CASES, "flash_attention 256x256 G10"),
      (80, STABLELM_ATTN_CASES, "flash_attention 80x80"),
      (128, LLAVA_ATTN_CASES, "flash_attention 128x128 G4"),
      (64, MUSICGEN_ATTN_CASES, "flash_attention 64x64 G1"),
      (64, TINYLLAMA_ATTN_CASES, "flash_attention 64x64 G8")):
    for b, sq, skv, h, hkv, causal, window in cases:
      gen = torch.Generator(device=dev).manual_seed(sq + window)
      q = torch.randn((b, sq, h, width), generator=gen, device=dev,
                      dtype=torch.bfloat16)
      k, v = (torch.randn((b, skv, hkv, width), generator=gen, device=dev,
                          dtype=torch.bfloat16) for _ in range(2))
      out = fa.flash_attention(q, k, v, causal, window=window)
      cmp = attn_close(out, q, k, v, causal, fa, window)
      max_err[key] = max(max_err[key], cmp["max_abs_err"])
      same = ""
      if window >= skv:
        check(torch.equal(out, fa.flash_attention(q, k, v, causal)),
              f"window {window} >= Skv {skv} differs from the causal output")
        same = "; bit for bit the causal output"
      say(f"kernels: flash_attention q ({b}, {sq}, {h}, {width}) kv ({skv}, "
          f"{hkv}) (G {h // hkv}) causal {causal} window {window}: "
          f"{attn_text(cmp, fa)}{same}")
  attn_option_checks(dev, fa, max_err)


def attn_option_checks(dev, fa, max_err) -> None:
  """Phase 3: the kernel with a soft-cap, a query offset and a window
  without ``causal`` (``OPTION_ATTN_CASES``), under autograd: one launch a
  call, the output against the plain version with the same options by
  the error model, and ``flash_attention_bwd``'s gradients against the
  plain version's autograd in f32 by the backward's."""
  for width, b, sq, skv, h, hkv, causal, window, softcap, q_offset in (
      OPTION_ATTN_CASES):
    gen = torch.Generator(device=dev).manual_seed(sq + window + q_offset)
    q = torch.randn((b, sq, h, width), generator=gen, device=dev,
                    dtype=torch.bfloat16) * (HOT_Q if softcap else 1.0)
    k, v = (torch.randn((b, skv, hkv, width), generator=gen, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    opts = dict(window=window, softcap=softcap, q_offset=q_offset)
    xs = [t.requires_grad_(True) for t in (q, k, v)]
    before = fa.LAUNCHES["flash_attention"]
    out = fa.flash_attention(*xs, causal, **opts)
    check(fa.LAUNCHES["flash_attention"] == before + 1,
          "flash_attention with options: not one launch")
    do = torch.randn(out.shape, generator=gen, device=dev,
                     dtype=torch.bfloat16)
    grads = torch.autograd.grad(out, xs, do)
    xs = [t.detach() for t in xs]
    masked = causal or window > 0
    cmp = fa.compare_with_plain(out.detach(), *xs, masked, **opts)
    check(cmp["finite"] and cmp["tol_ratio"] <= 1.0
          and cmp["rel_frob"] <= fa.REL_FROB_LIMIT,
          f"attention with {opts}: {attn_text(cmp, fa)}")
    key = attn_key(q, v)
    max_err[key] = max(max_err[key], cmp["max_abs_err"])
    texts = [f"forward: {attn_text(cmp, fa)}"]
    for name, c in fa.compare_bwd_with_plain(grads, *xs, do, masked,
                                             **opts).items():
      text = attn_text(c, fa, f"{name} - {name} of the plain version's "
                       "autograd in f32")
      check(c["finite"] and c["tol_ratio"] <= 1.0
            and c["rel_frob"] <= fa.REL_FROB_LIMIT,
            f"flash_attention_bwd {name} with {opts}: {text}")
      texts.append(text)
    say(f"kernels: flash_attention q ({b}, {sq}, {h}, {width}) kv ({skv}, "
        f"{hkv}) (G {h // hkv}) causal {causal} window {window} softcap "
        f"{softcap} q_offset {q_offset}"
        f"{' (q x ' + str(HOT_Q) + ')' if softcap else ''}, one launch: "
        + "; ".join(texts))


def pav_scan_checks(rng, dev, pav, pav_scan, theta_np, tokens_np, record,
                    jobs) -> None:
  """Phase 3: ``pav_l2`` / ``pav_kl`` against their plain versions
  ``pav_l2_scan`` / ``pav_kl_scan`` (the same divide-and-conquer merges in
  the same order) on the card, at every kernel shape, on the main, random
  and adversarial inputs; ``pav_kl`` also against the stack machine, with
  the same blocks, at (128, 1000).  The 2**20 adversarial rows' plain
  versions (2**19 steps of small ops at the top level) go to the CPU
  workers."""
  for rows, n in KERNEL_SHAPES:
    inputs = pav_inputs(rng, dev, rows, n, theta_np, tokens_np)
    for (kname, kind), args in inputs.items():
      out = getattr(pav, kname)(*args)
      plain_fn = f"{kname}_scan"
      if rows == 1 and kind == "adversarial":
        jobs.insert(0, (kname, f"{kind} input, plain divide and conquer",
                        (rows, n), out.cpu(), plain_fn,
                        tuple(a.cpu().numpy() for a in args)))
        continue
      plain = getattr(pav_scan, plain_fn)(*args)
      reason = KL_ON_CARD if kname == "pav_kl" else None
      say(f"kernels: {kname} ({rows}, {n}) {kind} input, plain divide and "
          f"conquer on the card: "
          f"{hold(kname, f'{(rows, n)} {kind}', out, plain, record, reason)}")
      if kname == "pav_kl" and (rows, n) == HEADLINE and kind != "adversarial":
        stack = pav.pav_kl_stack(*args)
        say(f"kernels: pav_kl ({rows}, {n}) {kind} input, plain stack "
            "machine on the card: " +
            hold("pav_kl vs stack", f"{(rows, n)} {kind}", out, stack,
                 record, "the stack machine pools in another order"))


# The engine's cells that phase 3 holds the PAV kernels on: its largest,
# a single short row, and two between; rows 1-32, n = bucket.
ENGINE_HOLD_SHAPES = ((32, 4096), (1, 64), (8, 2048), (32, 128))
ENGINE_HOLD_OPS = ("soft_rank/l2/desc", "soft_sort/l2/desc",
                   "soft_rank/kl/desc", "soft_sort/kl/desc")


def engine_kernel_inputs(dispatch, dev, rng):
  """The PAV kernels' inputs at the engine's shapes, as the engine's
  cells make them: batches assembled by ``ServingEngine._assemble`` (real
  rows with their pad tails, then pad rows) run through the bound
  soft_rank / soft_sort ops, with the cuda isotonic backend's inputs
  captured on the way.  Yields (kernel, what, inputs)."""
  from repro_torch.serving import EngineConfig, Request, ServingEngine
  from repro_torch.serving.ops import bound_op, padded_op
  engine = ServingEngine(EngineConfig(ops=ENGINE_HOLD_OPS, max_batch=32,
                                      device=dev.type))
  captured = []
  saved = {}
  for reg in ("l2", "kl"):
    key = ("isotonic", reg, "cuda")
    saved[key] = fn = dispatch._REGISTRY[key]

    def capture(*args, fn=fn, kname=f"pav_{reg}"):
      captured.append((kname, tuple(a.clone() for a in args)))
      return fn(*args)

    dispatch._REGISTRY[key] = capture
  try:
    for rows, bucket in ENGINE_HOLD_SHAPES:
      lo = 1 if bucket == 64 else bucket // 2 + 1
      # Row 0 full, the others padded; the (32, 128) batch ends in three
      # pad rows; the single row is a padded one.
      real = rows - 3 if (rows, bucket) == (32, 128) else rows
      ns = [37] if rows == 1 else [bucket] + [
          int(n) for n in rng.integers(lo, bucket, size=real - 1)]
      for kind in ("random", "ties"):
        for key in ENGINE_HOLD_OPS:
          reqs = []
          for n in ns:
            v = rng.normal(size=n).astype(np.float32) * 3
            if kind == "ties":
              v = np.round(v) / 2
            reqs.append(Request(op=key, values=v,
                                eps=float(rng.choice([0.1, 0.3, 1.0]))))
          args = engine._assemble(padded_op(key), reqs, rows, bucket)
          start = len(captured)
          with torch.no_grad():
            bound_op(key)(*[torch.from_numpy(a).to(dev) for a in args])
          for kname, inputs in captured[start:]:
            yield (kname, f"({rows}, {bucket}) {key} {kind}, "
                   f"{len(ns)} real rows", inputs)
  finally:
    dispatch._REGISTRY.update(saved)


def engine_kernel_checks(dev, pav, pav_scan, record, rng) -> None:
  """Phase 3, engine shapes: ``pav_l2`` / ``pav_kl`` bit for bit against
  ``pav_l2_scan`` / ``pav_kl_scan`` on the card (kl: an ulp only for the
  stated reason), on the inputs the engine's padded soft_rank / soft_sort
  cells give them (pad tails and pad rows included) and on random rows,
  at every shape of ``ENGINE_HOLD_SHAPES``."""
  from repro_torch.kernels import dispatch
  held = 0
  for kname, what, args in engine_kernel_inputs(dispatch, dev, rng):
    out = getattr(pav, kname)(*args)
    plain = getattr(pav_scan, f"{kname}_scan")(*args)
    reason = KL_ON_CARD if kname == "pav_kl" else None
    text = hold(kname, f"engine {what}", out, plain, record, reason)
    say(f"kernels: {kname} engine cell {what}, plain divide and conquer on "
        f"the card: {text}")
    held += 1
  for rows, n in ENGINE_HOLD_SHAPES:
    y, (s, w) = solver_inputs(rng, rows, n, "random")
    for kname, args in (("pav_l2", (y,)), ("pav_kl", (s, w))):
      args = [to_dev(a, dev) for a in args]
      out = getattr(pav, kname)(*args)
      plain = getattr(pav_scan, f"{kname}_scan")(*args)
      reason = KL_ON_CARD if kname == "pav_kl" else None
      text = hold(kname, f"({rows}, {n}) random", out, plain, record, reason)
      say(f"kernels: {kname} ({rows}, {n}) random input, plain divide and "
          f"conquer on the card: {text}")
      held += 1
  say(f"kernels: {held} engine-shape comparisons of pav_l2 / pav_kl with "
      f"their plain versions at {ENGINE_HOLD_SHAPES}")


class Recorder:
  """Wraps the kernel wrappers the models call (module attributes of
  ``soft_topk`` and ``flash_attention``) to keep each call's inputs and
  output (of attention, only the window with ``tensors=False``);
  ``plain=True`` routes the calls to the plain versions instead."""

  def __init__(self, st, fa, plain: bool = False, tensors: bool = True):
    self.st, self.fa, self.plain, self.tensors = st, fa, plain, tensors
    self.gates: list[tuple] = []    # (logits, k, eps, gates)
    self.attn: list[tuple] = []     # (q, k, v, causal, out)
    self.order: list[str] = []      # "gates" or "attn", call by call

  def __enter__(self):
    self._orig = (self.st.soft_topk_gates, self.fa.flash_attention)
    gates_fn = self.st.soft_topk_gates_plain if self.plain else self._orig[0]
    plain_fa = self.fa.flash_attention_plain

    def gates(logits, k, eps=1.0):
      out = gates_fn(logits, k, eps)
      self.gates.append((logits, k, eps, out))
      self.order.append("gates")
      return out

    def attn(q, k, v, causal=True, **opts):
      out = (plain_fa(q, k, v, causal=causal, **opts) if self.plain
             else self._orig[1](q, k, v, causal, **opts))
      self.keep_attn(q, k, v, causal, out, opts.get("window", 0))
      self.order.append("attn")
      return out

    self.st.soft_topk_gates, self.fa.flash_attention = gates, attn
    return self

  def __exit__(self, *exc):
    self.st.soft_topk_gates, self.fa.flash_attention = self._orig

  def keep_attn(self, q, k, v, causal, out, window) -> None:
    """Keep the call (only its window, with ``tensors=False``)."""
    self.attn.append((q, k, v, causal, out) if self.tensors else window)


def routed_experts(logits: torch.Tensor, gates: torch.Tensor,
                   k: int) -> torch.Tensor:
  """The k experts each token is sent to first (the dispatch's rounds of
  argmax over gates * softmax(logits), before capacity), as a 0/1 mask."""
  w = gates * torch.softmax(logits, dim=-1)
  top = torch.topk(w, k, dim=-1).indices
  return torch.zeros_like(w, dtype=torch.bool).scatter_(-1, top, True)


def held_attn(q, kx, v, causal, out, fa,
              window=0) -> tuple[int, dict, float]:
  """One attention call (q, k, v, causal, window, the kernel's out) held
  against the plain version in f32 by its error model (``attn_close``):
  (window, the measures, |kernel - plain in bf16|, the plain version run in
  the inputs' dtype: the reference's rounding, no tolerance)."""
  cmp = attn_close(out, q, kx, v, causal, fa, window)
  plain16 = fa.flash_attention_plain(q, kx, v, causal=causal, window=window)
  return window, cmp, float((out.float() - plain16.float()).abs().max())


def worst_of(held) -> tuple[dict, float]:
  """The worst of each measure over held calls (``held_attn``; median
  |ref|: the smallest), and the largest |kernel - plain in bf16|."""
  worst = {"max_abs_err": 0.0, "tol_ratio": 0.0, "rel_frob": 0.0,
           "median_ref": math.inf}
  for _, cmp, _ in held:
    for key in ("max_abs_err", "tol_ratio", "rel_frob"):
      worst[key] = max(worst[key], cmp[key])
    worst["median_ref"] = min(worst["median_ref"], cmp["median_ref"])
  return worst, max(bf16 for _, _, bf16 in held)


def captured_attn_checks(calls, fa) -> tuple[dict, float]:
  """The attention kernel's output on each captured call (q, k, v, causal,
  out) held against the plain version (``held_attn``); the worst of each
  measure (``worst_of``)."""
  return worst_of([held_attn(q, kx, v, causal, out, fa)
                   for q, kx, v, causal, out in calls])


def attention_layers(cfg) -> int:
  """The layers whose mixer runs the attention kernel (GQA or MLA: one
  launch each a prefill): none of the recurrent kinds (``rg``, ``mlstm``,
  ``slstm``)."""
  from repro_torch.models import transformer as T

  return sum(T.MIXERS[kind] in ("attn", "mla") for kind in cfg.layer_kinds())


def plain_prefill_text(res, rec, serve, st, fa) -> str:
  """The served prompts' prefill again on the plain versions (both kernels'
  wrappers routed to them), against the kernel path's (``rec``: its first
  ``num_layers`` gate calls are the prefill's): for a MoE model the routing
  decisions that differ, layer by layer; the largest difference of the
  last-position logits; the first greedy token's agreement."""
  cfg = res["cfg"]
  n_layers, b = cfg.num_layers, res["prompts"].shape[0]
  n_attn = attention_layers(cfg)
  with Recorder(st, fa, plain=True, tensors=False) as plain_rec:
    plain_res = serve.generate(cfg, res["model"], res["batch"], 1)
  check(len(plain_rec.attn) == n_attn
        and len(plain_rec.gates) == (n_layers if rec.gates else 0),
        "the plain prefill did not pass every attention layer")
  parts = []
  if rec.gates:
    k = cfg.experts_per_token
    per_layer, tokens_differ = [], 0
    for a, c in zip(rec.gates[:n_layers], plain_rec.gates):
      ra, rc = routed_experts(a[0], a[3], k), routed_experts(c[0], c[3], k)
      per_layer.append(int((ra & ~rc).sum()))
      tokens_differ += int((ra != rc).any(-1).sum())
    decisions = n_layers * res["prompts"].numel() * k
    parts.append(f"{sum(per_layer)} of {decisions} routing decisions differ "
                 f"({tokens_differ} token-layers); by layer {per_layer}")
  dl = (res["prefill_logits"] - plain_res["prefill_logits"]).abs().max()
  agree = int((res["tokens"][:, 0] == plain_res["tokens"][:, 0]).sum())
  parts.append(f"last-position logits differ by at most {float(dl):.3e} (max"
               f" |logit| {float(plain_res['prefill_logits'].abs().max()):.3e})")
  parts.append(f"first greedy token agrees in {agree} of {b} rows")
  return f"serve: {cfg.name} kernel-path vs plain-path prefill: " + "; ".join(
      parts)


def serve_path(dev, serve, ops, st, fa):
  """The serving path once with every counter from 0, then its checks.

  Returns (serve result, launches, kernel-path recorder, the worst error
  per kernel on the captured inputs)."""
  args = serve.parser().parse_args(
      ["--arch", ARCH, "--batch", str(SERVE_BATCH), "--prompt-len",
       str(SERVE_PROMPT), "--gen", str(SERVE_GEN)])
  from repro_torch.configs.base import get_config
  from repro_torch.models import transformer as T

  t0 = time.perf_counter()
  torch.cuda.reset_peak_memory_stats(dev)
  model = T.init_params(get_config(ARCH), args.seed, dev)
  torch.cuda.synchronize()
  say(f"serve: {ARCH} initialised on the card in "
      f"{time.perf_counter() - t0:.1f} s")

  ops.reset_all_launches()
  with Recorder(st, fa) as rec:
    res = serve.run_lm(args, model=model)
  torch.cuda.synchronize()
  launches = ops.all_launches()
  cfg = res["cfg"]
  n_layers, k = cfg.num_layers, cfg.experts_per_token
  steps = SERVE_GEN - 1
  say(f"serve: launches {launches} for 1 prefill and {steps} decode steps"
      f" of {n_layers} layers")
  n_prefill_gates = sum(1 for g in rec.gates if g[0].shape[0] ==
                        SERVE_BATCH * SERVE_PROMPT)
  check(launches["flash_attention"] == n_layers == len(rec.attn),
        f"flash_attention: {launches['flash_attention']} launches, "
        f"{n_layers} layers")
  check(launches["soft_topk_gates"] == n_layers * (1 + steps)
        == len(rec.gates) and n_prefill_gates == n_layers,
        f"soft_topk_gates: {launches['soft_topk_gates']} launches for "
        f"{n_layers} x {1 + steps} calls")
  check(launches["pav_l2"] == launches["pav_kl"] == 0,
        "a PAV kernel ran on the serving path")
  check(launches["flash_attention_simt"] == 0,
        "the CUDA-core attention kernel ran on the bf16 serving path")
  check(launches["decode_attention"] == 0,
        "the decode attention kernel ran on MLA's serving path")
  params = T.count_params(res["model"])
  check(abs(params - 16.21e9) < 0.01e9, f"{params} parameters")
  for name in ("prefill_logits", "logits"):
    logits = res[name]
    check(tuple(logits.shape) == (SERVE_BATCH, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), f"{name}: not finite")
  sums = max(float((g[3].sum(-1) - k).abs().max()) for g in rec.gates)
  check(sums <= 1e-4, f"gate row sums off k by {sums:.3e}")
  say(f"serve: {params:,} parameters; logits finite; every gate row sums "
      f"to k within {sums:.1e}; peak memory "
      f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")

  # Each kernel against its plain version on the inputs of every layer.
  worst = {"soft_topk_gates": 0.0, "flash_attention": 0.0}
  for logits, kk, eps, out in rec.gates[:n_layers]:
    plain = st.soft_topk_gates_plain(logits, kk, eps)
    check(torch.equal(out, plain), "soft_topk_gates: a captured layer's "
          f"gates differ from the plain version in "
          f"{int((out != plain).sum())} elements")
    worst["soft_topk_gates"] = max(worst["soft_topk_gates"],
                                   close(out, plain))
  worst_attn, worst_bf16 = captured_attn_checks(rec.attn, fa)
  worst["flash_attention"] = worst_attn["max_abs_err"]
  say(f"serve: on the captured inputs of all {n_layers} layers: "
      f"soft_topk_gates max |kernel - plain| {worst['soft_topk_gates']:.3e}"
      f" (tol 1e-5 * (1 + max|plain|)); flash_attention, worst layer by "
      f"each measure (median |ref|: the smallest layer's), "
      f"{attn_text(worst_attn, fa)}; max |kernel - plain in bf16| "
      f"{worst_bf16:.3e} (the reference's rounding, no tolerance)")

  say(plain_prefill_text(res, rec, serve, st, fa))
  return res, launches, rec, worst


def gates_bound(logits: torch.Tensor, k: int, eps: float,
                st) -> tuple[float, str]:
  """Least time for the gates on these logits: bytes (logits in, gates
  out, f32) against operations at the f32 rate: the sort network's
  compare-exchanges (the row padded to 32, 64 or 128 slots, one operation
  each), one operation an element each for the scaling, y = s - w and the
  gate, and 4 a position the pool absorbs (add, count, divide, compare),
  counted from these rows' fit."""
  rows, e = logits.shape
  slots = 32 if e <= 32 else 64 if e <= 64 else 128
  stages = int(math.log2(slots)) * (int(math.log2(slots)) + 1) // 2
  z = logits.float() / eps
  s = torch.sort(z, dim=-1, descending=True, stable=True).values
  y = s - (torch.arange(e, device=z.device) < k).to(z.dtype)
  v = st.pool_at_k(y, k)
  blocks = rows + int((v[:, 1:] != v[:, :-1]).sum())
  n_ops = (rows * (slots // 2) * stages + 3 * rows * e
           + 4 * (rows * e - blocks))
  bytes_ms = rows * e * 8 / HBM_BYTES_PER_S * 1e3
  ops_ms = n_ops / F32_OPS_PER_S * 1e3
  return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def attn_bound(q, k, v, causal: bool, window: int = 0, softcap: float = 0.0,
               q_offset: int = 0) -> tuple[float, str]:
  """Least time for attention: bytes (q, k, v read once, out written once)
  against the tensor-core products (QK^T and PV over the unmasked pairs:
  query i at position p = q_offset + i sees min(p + 1, Skv) keys, under a
  window those above p - window) plus the softmax (5 f32 ops a score; a
  soft-cap 2 more, its multiply and its tanh counted as one) at the f32
  rate."""
  from repro_torch.kernels.flash_attention import attention_pairs
  b, sq, h, d = q.shape
  skv, dv = k.shape[1], v.shape[-1]
  pairs = attention_pairs(sq, skv, causal, window, q_offset)
  n_bytes = (q.numel() + k.numel() + v.numel() + b * sq * h * dv) * 2
  flops = 2 * b * h * pairs * (d + dv)
  score_ops = 5 + (2 if softcap > 0 else 0)
  bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
  ops_ms = (flops / BF16_OPS_PER_S
            + score_ops * b * h * pairs / F32_OPS_PER_S) * 1e3
  return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


# torch.profiler on the card now and then records no device time in a
# session (CUPTI); a reading is taken again up to this many times, and if
# none shows device time it is reported as not measured.
PROFILER_TRIES = 3
# Once the script has started and ended other processes (its CPU workers),
# every profiler session on the card loses the records of its first 2 to 6
# kernel launches, whatever it waits for: a 20-launch session holds 14-18
# of them and a one-launch session none (NVIDIA H100 80GB HBM3).  So each
# session opens with this many launches of the pad kernel,
# ``torch.cuda._sleep``'s ``spin_kernel``, for the loss to take; readings
# leave them out.
PROFILER_PAD = 16
PAD_KERNEL = "spin_kernel"


# The CUDA kernel that each port kernel's wrapper launches first, once a
# launch, as the profiler names it (every part in the name): a profiled
# call's records of them are held to the wrappers' launch counts.
FIRST_KERNELS = {"pav_l2": ("tile_kernel", "L2Algebra"),
                 "pav_kl": ("tile_kernel", "KlAlgebra"),
                 "soft_topk_gates": ("soft_topk_kernel",),
                 "flash_attention": ("flash_kernel",),
                 "flash_attention_simt": ("attention_simt",),
                 "decode_attention": ("decode_split",)}
NOT_PROFILED = "not measured (no profiler session recorded every launch)"


@contextlib.contextmanager
def padded_profile():
  """A torch.profiler session (CPU and CUDA) that opens with
  ``PROFILER_PAD`` pad kernels (a microsecond each) and closes once the
  device has finished."""
  from torch.profiler import ProfilerActivity
  from torch.profiler import profile as torch_profile

  torch.cuda.synchronize()
  with torch_profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
    for _ in range(PROFILER_PAD):
      torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    yield prof
    torch.cuda.synchronize()


def read_profile(prof, ranges=()) -> tuple[dict, dict]:
  """(every kernel by name: [device ms, launches]; for each name in
  ``ranges`` [host ms, device span ms, the device ms of the kernels
  launched inside it, their count], summed over its occurrences), in one
  pass over the profiler's raw events: torch's own ``events()`` and
  ``key_averages()`` take minutes over a train step's 10^5-10^6 launches.
  A kernel belongs to the PyTorch op whose correlation id is its linked
  one (as torch's own reading pairs them), and to a range when that op
  started inside the range on the range's thread.  The ranges (all named
  repro_...) also show as CUDA events spanning their kernels: not kernels
  themselves; nor are the session's pad kernels (``padded_profile``)."""
  from torch.autograd import DeviceType

  kernels: dict[str, list] = {}
  spans = {name: [0.0, 0.0, 0.0, 0] for name in ranges}
  ops, windows, launched = {}, [], []
  for e in prof.profiler.kineto_results.events():
    name = e.name()
    if e.device_type() == DeviceType.CUDA:
      ms = e.duration_ns() / 1e6
      if name.startswith("repro_") or PAD_KERNEL in name:
        if name in spans:
          spans[name][1] += ms
        continue
      k = kernels.setdefault(name, [0.0, 0])
      k[0] += ms
      k[1] += 1
      if ranges:
        launched.append((e.linked_correlation_id(), ms))
    elif ranges and e.linked_correlation_id() == 0:
      if name in spans:
        spans[name][0] += e.duration_ns() / 1e6
        windows.append((e.start_thread_id(), e.start_ns(),
                        e.start_ns() + e.duration_ns(), name))
      else:
        ops[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
  for corr, ms in launched:
    op = ops.get(corr)
    for tid, lo, hi, name in windows if op else ():
      if op[0] == tid and lo <= op[1] <= hi:
        spans[name][2] += ms
        spans[name][3] += 1
        break
  return kernels, spans


def unrecorded(kernels: dict, launched: dict[str, int]) -> str:
  """Which port kernels a profile's ``kernels`` (name: [device ms,
  launches]) hold fewer or more launches of than their wrappers counted
  (``launched``, by kernel, as ``ops.all_launches`` names them), as
  "pav_l2 3 of 4, ..."; "" when every count is met."""
  short = []
  for kname, want in launched.items():
    parts = FIRST_KERNELS[kname]
    got = sum(n for name, (_, n) in kernels.items()
              if all(p in name for p in parts))
    if got != want:
      short.append(f"{kname} {got} of {want}")
  return ", ".join(short)


def profile(fn, ranges=()) -> tuple[float, float | None,
                                    list[tuple[str, float, int]], dict]:
  """One call of ``fn`` under torch.profiler: (wall ms, device busy ms,
  every kernel with its device ms and launch count, the most device time
  first, and for each name in ``ranges`` (a ``record_function`` range)
  [its host ms, its device span from its first kernel's start to its last
  kernel's end, the device ms of the kernels launched inside it and their
  count], each summed over its occurrences).  Busy time is the sum of the
  kernels' own device times (one stream: they do not overlap).  A session
  counts only if it recorded every launch of the port's kernels that
  their wrappers counted in the call (``unrecorded``); if none of
  ``PROFILER_TRIES`` does, busy is None, with a line that says why, and
  nothing else of the profile is returned: never a partial sum."""
  from repro_torch.kernels import ops as kops

  why = []
  for _ in range(PROFILER_TRIES):
    with padded_profile() as prof:
      before = kops.all_launches()
      t0 = time.perf_counter()
      fn()
      torch.cuda.synchronize()
      wall = (time.perf_counter() - t0) * 1e3
      launched = {k: n - before[k] for k, n in kops.all_launches().items()}
      t1 = time.perf_counter()
    t2 = time.perf_counter()
    kernels, spans = read_profile(prof, ranges)
    busy = sum(ms for ms, _ in kernels.values())
    say(f"clock: profiled {wall / 1e3:.1f} s of work; the profiler's own "
        f"stop {t2 - t1:.1f} s, reading its events "
        f"{time.perf_counter() - t2:.1f} s")
    lost = unrecorded(kernels, launched) if busy > 0 else "no device time"
    if not lost:
      if why:
        say(f"profiler: a profiled call measured on try {len(why) + 1} "
            f"after: {'; '.join(why)}")
      top = sorted(((name, ms, n) for name, (ms, n) in kernels.items()),
                   key=lambda t: -t[1])
      return wall, busy, top, spans
    why.append(f"recorded {lost}")
  say(f"profiler: a profiled call not measured: {'; '.join(why)}")
  return wall, None, [], {}


def device_reading(entries, names, calls: int, per_call: int,
                   bound_ms: float | None = None
                   ) -> tuple[float | None, str]:
  """Device ms per call from a profile's ``key_averages()`` entries of
  ``calls`` calls, summed over the CUDA entries whose keys contain one of
  ``names`` (``""`` matches every kernel), or None and the reason: the
  profile must hold every launch, ``calls * per_call`` of them (a session
  that loses events would give a partial sum), and where the caller knows
  the kernel's bound, a reading under it is not a time the card can take."""
  from torch.autograd import DeviceType

  matched = [e for e in entries if e.device_type == DeviceType.CUDA
             and PAD_KERNEL not in e.key and any(n in e.key for n in names)]
  count = sum(e.count for e in matched)
  want = calls * per_call
  if count != want:
    return None, f"{count} of {want} launches recorded"
  ms = sum(e.self_device_time_total for e in matched) / 1e3 / calls
  if bound_ms is not None and ms < bound_ms:
    return None, f"{ms:.5f} ms a call, below its bound {bound_ms:.5f} ms"
  return ms, ""


def kernel_device_ms(fn, name, calls: int = 20,
                     bound_ms: float | None = None,
                     launches: int = 1) -> float | None:
  """Device time per call of the CUDA kernels whose names contain
  ``name`` (or one of a tuple of names; ``""``: every kernel ``fn`` runs),
  from torch.profiler over ``calls`` calls of ``fn``: their own time,
  whatever the host spends around them.  One call makes ``launches`` of
  the named kernels (a PAV call as many as ``pav.kernels_a_call`` says);
  of ``""`` the launches are counted in a profile of one call, each try
  anew.  The reading must hold ``calls`` times as many
  (``device_reading``; with the bound, where the caller gives it).  None,
  with a line that says why, if no try of ``PROFILER_TRIES`` gives such a
  reading: never a partial sum."""

  def entries(n: int):
    with padded_profile() as prof:
      for _ in range(n):
        fn()
    return prof.key_averages()

  fn()
  names = (name,) if isinstance(name, str) else name
  why = []
  for _ in range(PROFILER_TRIES):
    per_call = launches if names != ("",) else sum(
        e.count for e in entries(1)
        if e.device_type == torch.autograd.DeviceType.CUDA
        and PAD_KERNEL not in e.key)
    if per_call == 0:
      why.append("no launch recorded in the one-call profile")
      continue
    ms, reason = device_reading(entries(calls), names, calls, per_call,
                                bound_ms)
    if ms is not None:
      if why:
        say(f"profiler: kernels {names!r} measured on try {len(why) + 1} "
            f"after: {'; '.join(why)}")
      return ms
    why.append(f"{reason} ({per_call} a call)")
  say(f"profiler: kernels {names!r} not measured: {'; '.join(why)}")
  return None


def ms_text(ms: float | None) -> str:
  return "not measured" if ms is None else f"{ms:.4f} ms"


def share(bound_ms: float, ms: float | None) -> str:
  return "not measured" if ms is None else f"{bound_ms / ms:.1%}"


def sdpa_backend(fn) -> str:
  """The backend that ran one call of scaled_dot_product_attention, from
  the name of its longest kernel in torch.profiler: cudnn, flash,
  efficient (memory-efficient, CUTLASS fmha), or math (plain products and
  a softmax)."""
  from torch.autograd import DeviceType

  fn()
  for _ in range(PROFILER_TRIES):
    with padded_profile() as prof:
      fn()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and PAD_KERNEL not in e.key),
                     key=lambda e: -e.self_device_time_total)
    if kernels:
      name = kernels[0].key
      low = name.lower()
      kind = ("cudnn" if "cudnn" in low else "flash" if "flash" in low
              else "efficient" if "fmha" in low or "efficient" in low
              else "math")
      return f"{kind} (longest kernel {name[:60]})"
  return "not measured"


def band_mask(q, k, window: int) -> torch.Tensor | None:
  """The sliding window as SDPA's boolean (Sq, Skv) mask (it has no window
  of its own): query i sees keys i - window + 1 .. i; None for no window."""
  if not window:
    return None
  i = torch.arange(q.shape[1], device=q.device)[:, None]
  j = torch.arange(k.shape[1], device=q.device)[None]
  return (j <= i) & (j > i - window)


def attn_times(q, kx, v, causal: bool, fa, name_limit,
               window: int = 0) -> tuple[dict, str]:
  """The attention kernel at one shape: CUDA-event median and profiler
  device time, the plain version, scaled_dot_product_attention (GQA
  through ``enable_gqa``) as the library yardstick, and the bound.  Under
  a window SDPA takes an explicit boolean (S, S) band mask, which none of
  its fused causal paths takes: its backend is named, and its work is the
  whole masked product, not the band's."""
  bound_ms, bound_by = attn_bound(q, kx, v, causal, window)
  ms = median_ms(lambda: fa.flash_attention(q, kx, v, causal,
                                            window=window), 20)
  dev_ms = kernel_device_ms(lambda: fa.flash_attention(q, kx, v, causal,
                                                       window=window),
                            "flash_kernel", bound_ms=bound_ms)
  plain_ms = median_ms(lambda: fa.flash_attention_plain(
      q, kx, v, causal=causal, window=window), 5)
  qt, kt, vt = (t.transpose(1, 2) for t in (q, kx, v))
  gqa = q.shape[2] != kx.shape[2]
  mask = band_mask(q, kx, window)

  def sdpa():
    torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and not window,
        enable_gqa=gqa)

  lib_ms = median_ms(sdpa, 20)
  # every kernel of the call, the same work
  lib_dev_ms = kernel_device_ms(sdpa, "", bound_ms=bound_ms)
  backend = sdpa_backend(sdpa)
  row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
         "bound_by": bound_by, "library_ms": lib_ms, "shape": list(q.shape),
         "width": [q.shape[-1], v.shape[-1]], "device_ms": dev_ms,
         "window": window, "library_backend": backend}
  mask_text = (f"window {window}" if window else
               "causal" if causal else "not causal")
  line = (f"times: flash_attention q {tuple(q.shape)} k {tuple(kx.shape)} v "
          f"{tuple(v.shape)} {mask_text}: kernel {ms:.4f} ms (device "
          f"{ms_text(dev_ms)} a launch, profiler), plain "
          f"{plain_ms:.4f} ms, scaled_dot_product_attention "
          f"{lib_ms:.4f} ms (device {ms_text(lib_dev_ms)}, profiler; "
          f"{'a boolean band mask, ' if window else ''}backend {backend}), "
          f"bound {bound_ms:.5f} ms ({bound_by}); the "
          f"bound is {share(bound_ms, ms)} of the kernel's time "
          f"({share(bound_ms, dev_ms)} of its device time) and "
          f"{share(bound_ms, lib_ms)} of SDPA's "
          f"({share(bound_ms, lib_dev_ms)} of its device time) "
          f"[{name_limit}]")
  return row, line


# The options' times in phase 5, at each option width's serving prefill
# (B, S, H, Hkv, D): llama's (64, 64), grok's (128, 128), gemma's (256, 256)
# global layers.
OPTION_TIME_SHAPES = ((SERVE_BATCH, SERVE_PROMPT, 32, 8, 64),
                      (SERVE_BATCH, SERVE_PROMPT, 48, 8, 128),
                      (SERVE_BATCH, 2048, 16, 8, 256))


def attn_option_times(dev, fa, name_limit) -> tuple[list[str], list[dict]]:
  """The kernel with each option beside the same shape without it, on the
  same inputs (q scaled by HOT_Q, so that the soft-cap binds): causal;
  soft-cap 30; the last S / 2 queries over the S keys (q_offset = S / 2);
  a window of S / 4 without ``causal``, and with it (the same kernel).
  CUDA-event medians and the profiler's device time, with the bound."""
  lines, rows = [], []
  for b, s, h, hkv, d in OPTION_TIME_SHAPES:
    gen = torch.Generator(device=dev).manual_seed(s + d)
    q = torch.randn((b, s, h, d), generator=gen, device=dev,
                    dtype=torch.bfloat16) * HOT_Q
    k, v = (torch.randn((b, s, hkv, d), generator=gen, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    half = q[:, s // 2:].contiguous()
    for what, qx, causal, opts in (
        ("causal", q, True, {}),
        ("causal, softcap 30", q, True, dict(softcap=30.0)),
        (f"causal, last {s // 2} queries, q_offset {s // 2}", half, True,
         dict(q_offset=s // 2)),
        (f"window {s // 4}, causal False", q, False, dict(window=s // 4)),
        (f"window {s // 4}, causal True", q, True, dict(window=s // 4))):
      call = lambda: fa.flash_attention(qx, k, v, causal, **opts)  # noqa
      bound_ms, bound_by = attn_bound(qx, k, v, causal, **opts)
      ms = median_ms(call, 20)
      dev_ms = kernel_device_ms(call, "flash_kernel", bound_ms=bound_ms)
      rows.append({"shape": list(qx.shape), "width": [d, d],
                   "causal": causal, **opts, "ms": ms, "device_ms": dev_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by})
      lines.append(f"times: flash_attention options q {tuple(qx.shape)} k "
                   f"{tuple(k.shape)} {what}: kernel {ms:.4f} ms (device "
                   f"{ms_text(dev_ms)} a launch, profiler), bound "
                   f"{bound_ms:.5f} ms ({bound_by}), "
                   f"{share(bound_ms, dev_ms)} of its device time "
                   f"[{name_limit}]")
  return lines, rows


# The sLSTM scan's ranges (``models/xlstm.py``): the forward, which remat
# runs again inside the backward, and the hand-written backward.
SLSTM_RANGES = ("repro_slstm_scan", "repro_slstm_scan_bwd")


def range_share_text(wall, busy, top, spans, names) -> str:
  """The share of a profiled call that the ranges ``names`` take: host ms
  of the wall, device ms of their kernels of the busy time, their launches
  of all launches."""
  if busy is None or any(n not in spans for n in names):
    return NOT_PROFILED
  launches = sum(n for _, _, n in top)
  host = sum(spans[n][0] for n in names)
  dev = sum(spans[n][2] for n in names)
  count = sum(spans[n][3] for n in names)
  if not count:
    return "not measured (no kernel under the ranges)"
  return (f"host {host:.1f} ms of the {wall:.1f} ms wall "
          f"({host / wall:.1%}); device {dev:.2f} ms of the {busy:.2f} ms "
          f"busy ({dev / busy:.1%}); {count} of {launches} launches "
          f"({count / max(launches, 1):.1%}); device span "
          + " + ".join(f"{spans[n][1]:.1f}" for n in names) + " ms")


def profile_line(cfg, name, fn, name_limit) -> str:
  """One profiled call of ``fn``: wall, busy and idle, launches, the top
  kernels and, for a model with ``slstm`` layers, the sLSTM scan's share."""
  slstm = "slstm" in cfg.layer_kinds()
  wall, busy, top, spans = profile(fn, SLSTM_RANGES if slstm else ())
  kernels = "; ".join(f"{key[:60]} {ms:.2f}" for key, ms, _ in top[:5])
  busy_text = (NOT_PROFILED
               if busy is None else
               f"{busy:.2f} ms ({100 * (1 - busy / wall):.0f}% idle) in "
               f"{sum(n for _, _, n in top)} launches")
  share = (f"; the {cfg.layer_kinds().count('slstm')} slstm layers' scans "
           + range_share_text(wall, busy, top, spans, SLSTM_RANGES[:1])
           if slstm else "")
  return (f"times: profile of one {cfg.name} {name}: wall {wall:.2f} ms, "
          f"device busy {busy_text}; most device time (ms): {kernels}"
          f"{share} [{name_limit}]")


def generate_times(res, serve, name_limit) -> list[str]:
  """The server's prefill ms and decode rate over 3 more runs (each
  checked to give the first run's tokens), and one profiled prefill and
  decode step."""
  cfg, lines = res["cfg"], []
  prefill, decode, same = [], [], 0
  for _ in range(3):
    again = serve.generate(cfg, res["model"], res["batch"], SERVE_GEN)
    same += int(torch.equal(again["tokens"], res["tokens"]))
    prefill.append(again["prefill_s"] * 1e3)
    decode.append((SERVE_GEN - 1) * SERVE_BATCH / again["decode_s"])
  lines.append(f"times: serve {cfg.name}: {same} of 3 timed runs generated "
               "the first run's tokens")
  from repro_torch.launch import steps

  batch, model = res["batch"], res["model"]
  s = steps.prefill_length(cfg, batch)
  state = {}

  def prefill_once():
    with torch.inference_mode():
      state["logits"], state["caches"] = steps.make_prefill_step(
          cfg, s + 2)(model, batch)

  def decode_once():
    with torch.inference_mode():
      steps.make_decode_step(cfg)(model, state["caches"],
                                  serve.greedy(state["logits"]), s)

  for name, fn in (("prefill", prefill_once), ("decode step", decode_once)):
    lines.append(profile_line(cfg, name, fn, name_limit))
  lines.append(f"times: serve {cfg.name} prefill {SERVE_BATCH}x{s}"
               f" {statistics.median(prefill):.2f} ms (runs "
               f"{', '.join(f'{t:.2f}' for t in prefill)}), decode "
               f"{statistics.median(decode):.1f} tok/s at batch {SERVE_BATCH}"
               f" (runs {', '.join(f'{t:.1f}' for t in decode)}) "
               f"[{name_limit}]")
  return lines


def gates_times(cfg, rec, st, name_limit) -> tuple[list[dict], list[str]]:
  """The gate kernel on a prefill layer's and a decode step's captured
  logits (the first and the last call): CUDA-event median and profiler
  device time, the plain version, the bound.  Returns a row for each."""
  rows, lines = [], []
  k, eps = cfg.experts_per_token, cfg.router_eps
  for logits in (rec.gates[0][0], rec.gates[-1][0]):
    bound_ms, bound_by = gates_bound(logits, k, eps, st)
    ms = median_ms(lambda: st.soft_topk_gates(logits, k, eps), 20)
    dev_ms = kernel_device_ms(lambda: st.soft_topk_gates(logits, k, eps),
                              "soft_topk_kernel", bound_ms=bound_ms)
    plain_ms = median_ms(lambda: st.soft_topk_gates_plain(logits, k, eps), 3)
    shape = tuple(logits.shape)
    rows.append({"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": None,
                 "shape": list(shape), "device_ms": dev_ms})
    lines.append(f"times: soft_topk_gates {shape} k {k}: kernel {ms:.4f} ms"
                 f" (device {ms_text(dev_ms)} a launch, profiler), plain "
                 f"{plain_ms:.3f} ms, bound {bound_ms:.3e} ms ({bound_by}) "
                 f"[{name_limit}]")
  return rows, lines


def serve_times(res, rec, serve, st, fa, name_limit):
  """Phase 5, serving deepseek: kernel, plain and library times at the
  path's own shapes, and the server's prefill ms and decode rate on more
  runs."""
  cfg = res["cfg"]
  gate_rows, lines = gates_times(cfg, rec, st, name_limit)
  rows = {"soft_topk_gates": gate_rows[0]}
  q, kx, v, causal, _ = rec.attn[0]
  rows["flash_attention"], line = attn_times(q, kx, v, causal, fa,
                                             name_limit)
  lines.append(line)
  lines += generate_times(res, serve, name_limit)
  return rows, lines


# ---------------------------------------------------------------------------
# The dense serving path (llama3.2-1b at full width and depth).
# ---------------------------------------------------------------------------

DENSE_ARCH = "llama3.2-1b"
# (layers, d_model, heads, kv heads, head width, tied): full width, depth.
DENSE_SHAPE = (16, 2048, 32, 8, 64, True)
# Counted from the config: 16 layers of 60,821,504 (attention 10,485,760,
# SwiGLU 50,331,648, two norm scales), the tied table 128256 x 2048 once,
# the final norm.
DENSE_PARAMS = 1_235_814_400


def dense_serve_path(dev, serve, ops, st, fa):
  """llama3.2-1b's serving path once with every counter from 0, then its
  checks: launches (flash_attention once a layer a prefill,
  decode_attention once a layer a decode step, nothing else), parameters,
  finite
  logits, the kernel on every layer's captured inputs, and the same
  prefill on the plain versions.  Returns (serve result, launches,
  recorder, the kernel's worst error on the captured inputs)."""
  args = serve.parser().parse_args(
      ["--arch", DENSE_ARCH, "--batch", str(SERVE_BATCH), "--prompt-len",
       str(SERVE_PROMPT), "--gen", str(SERVE_GEN)])
  from repro_torch.configs.base import get_config
  from repro_torch.models import transformer as T

  held = torch.cuda.memory_allocated(dev)
  torch.cuda.reset_peak_memory_stats(dev)
  t0 = time.perf_counter()
  model = T.init_params(get_config(DENSE_ARCH), args.seed, dev)
  torch.cuda.synchronize()
  init_peak = torch.cuda.max_memory_allocated(dev)
  weights = torch.cuda.memory_allocated(dev) - held
  torch.cuda.reset_peak_memory_stats(dev)
  say(f"serve: {DENSE_ARCH} initialised on the card in "
      f"{time.perf_counter() - t0:.1f} s: {weights / 2**30:.3f} GiB of "
      f"weights, peak {init_peak / 2**30:.3f} GiB while building them")

  ops.reset_all_launches()
  with Recorder(st, fa) as rec:
    res = serve.run_lm(args, model=model)
  torch.cuda.synchronize()
  launches = ops.all_launches()
  cfg = res["cfg"]
  n_layers = cfg.num_layers
  check((n_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
         cfg.head_dim, cfg.tie_embeddings) == DENSE_SHAPE,
        f"{DENSE_ARCH} config {cfg}")
  want = {"pav_l2": 0, "pav_kl": 0, "soft_topk_gates": 0,
          "flash_attention": n_layers, "flash_attention_simt": 0,
          "decode_attention": n_layers * (SERVE_GEN - 1)}
  check(launches == want and len(rec.attn) == n_layers and not rec.gates,
        f"{DENSE_ARCH} serve launches {launches}, counted from the code "
        f"{want}")
  say(f"serve: {DENSE_ARCH} launches {launches} for 1 prefill and "
      f"{SERVE_GEN - 1} decode steps of {n_layers} layers (counted from the"
      f" code: flash_attention once a layer a prefill, decode_attention "
      "once a layer a decode step, nothing else)")
  params = T.count_params(res["model"])
  check(params == DENSE_PARAMS, f"{params} parameters, not {DENSE_PARAMS}")
  check(not hasattr(res["model"], "lm_head"), "a tied model has an lm_head")
  for name in ("prefill_logits", "logits"):
    logits = res[name]
    check(tuple(logits.shape) == (SERVE_BATCH, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), f"{name}: not finite")
  q, kx, v, _, _ = rec.attn[0]
  check(tuple(q.shape) == (SERVE_BATCH, SERVE_PROMPT, cfg.num_heads,
                           cfg.head_dim)
        and tuple(kx.shape) == tuple(v.shape)
        == (SERVE_BATCH, SERVE_PROMPT, cfg.num_kv_heads, cfg.head_dim),
        f"captured attention shapes {q.shape}, {kx.shape}, {v.shape}")
  res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
  captured = sum(t.numel() * t.element_size()
                 for call in rec.attn for t in (call[0], call[1], call[2],
                                                call[4]))
  say(f"serve: {DENSE_ARCH} {params:,} parameters (the tied table once); "
      f"logits finite; peak memory while serving {res['peak_gib']:.3f} "
      f"GiB, of which {held / 2**30:.3f} GiB were held before the model was "
      f"built and {captured / 2**30:.3f} GiB are the recorder's captured "
      "attention inputs and outputs")

  worst_attn, worst_bf16 = captured_attn_checks(rec.attn, fa)
  worst = {"flash_attention 64x64": worst_attn["max_abs_err"]}
  say(f"serve: {DENSE_ARCH} flash_attention on the captured inputs of all "
      f"{n_layers} layers, worst layer by each measure (median |ref|: the "
      f"smallest layer's), {attn_text(worst_attn, fa)}; max |kernel - plain"
      f" in bf16| {worst_bf16:.3e} (the reference's rounding, no "
      "tolerance)")

  say(plain_prefill_text(res, rec, serve, st, fa))
  return res, launches, rec, worst


def dense_serve_times(res, rec, serve, fa, name_limit):
  """The dense serving path's times: the attention kernel at the prefill
  shape, then the server's."""
  q, kx, v, causal, _ = rec.attn[0]
  row, line = attn_times(q, kx, v, causal, fa, name_limit)
  return row, [line] + generate_times(res, serve, name_limit)


# llama3.2-1b again in f32 (``--set dtype=float32``): every attention layer
# on the CUDA-core kernel's FFMA path, the one f32 model served whole.
DENSE_F32_ARGV = ["--set", "dtype=float32"]


def dense_f32_serve(dev, serve, ops, st, fa, name_limit):
  """llama3.2-1b at full width and depth in f32, 8 x 512 prompts and 31
  decode steps through ``serve.run_lm``, every counter from 0: launches
  (``flash_attention_simt`` once a layer a prefill, nothing else), f32
  parameters, finite logits, the kernel on every layer's captured inputs
  by the f32 error model, the same prefill on the plain versions, then the
  server's times and one profiled prefill: its ms and the kernel's share of
  its device time.  Returns (launches, the time row, lines)."""
  import dataclasses

  from repro_torch.configs.base import get_config
  from repro_torch.launch import steps
  from repro_torch.models import transformer as T

  args = serve.parser().parse_args(
      ["--arch", DENSE_ARCH, "--batch", str(SERVE_BATCH), "--prompt-len",
       str(SERVE_PROMPT), "--gen", str(SERVE_GEN), *DENSE_F32_ARGV])
  cfg = dataclasses.replace(get_config(DENSE_ARCH), dtype="float32")
  model = T.init_params(cfg, args.seed, dev)
  torch.cuda.synchronize()
  ops.reset_all_launches()
  with Recorder(st, fa) as rec:
    res = serve.run_lm(args, model=model)
  torch.cuda.synchronize()
  launches = ops.all_launches()
  n_layers = res["cfg"].num_layers
  want = {"pav_l2": 0, "pav_kl": 0, "soft_topk_gates": 0,
          "flash_attention": 0, SIMT: n_layers,
          "decode_attention": n_layers * (SERVE_GEN - 1)}
  check(launches == want and len(rec.attn) == n_layers,
        f"{DENSE_ARCH} f32 serve launches {launches}, counted from the code "
        f"{want}")
  check(res["cfg"].dtype == "float32" and all(
      p.dtype == F32 for p in res["model"].parameters()),
        f"{DENSE_ARCH} --set dtype=float32 did not build f32 weights")
  for name in ("prefill_logits", "logits"):
    logits = res[name]
    check(tuple(logits.shape) == (SERVE_BATCH, res["cfg"].vocab_size)
          and logits.dtype == F32 and bool(torch.isfinite(logits).all()),
          f"f32 {name}: not finite")
  worst = {"max_abs_err": 0.0, "tol_ratio": 0.0, "rel_frob": 0.0}
  for q, kx, v, causal, out in rec.attn:
    check(q.dtype == F32 and out.dtype == F32,
          f"f32 serve: attention ran in {q.dtype}")
    cmp = fa.compare_with_plain(out, q, kx, v, causal)
    check(cmp["finite"] and cmp["tol_ratio"] <= 1.0
          and cmp["rel_frob"] <= cmp["rel_frob_limit"],
          f"{SIMT} on a captured f32 llama layer: {simt_text(cmp)}")
    for key in worst:
      worst[key] = max(worst[key], cmp[key])
  say(f"serve: {DENSE_ARCH} in f32 ({' '.join(DENSE_F32_ARGV)}) launches "
      f"{launches} for 1 prefill and {SERVE_GEN - 1} decode steps of "
      f"{n_layers} layers (counted from the code: {SIMT} once a layer a "
      f"prefill, decode_attention once a layer a decode step, nothing "
      f"else); logits finite; {SIMT} on the captured "
      f"inputs of all {n_layers} layers, worst layer by each measure (f32 "
      f"model): max |kernel - plain in f32| {worst['max_abs_err']:.3e}, "
      f"|err| / tol {worst['tol_ratio']:.4f} (limit 1), relative Frobenius "
      f"{worst['rel_frob']:.3e} (limit {fa.F32_REL_FROB_LIMIT:.3e})")
  say(plain_prefill_text(res, rec, serve, st, fa))
  q, kx, v, causal, _ = rec.attn[0]
  shape = (tuple(q.shape), tuple(kx.shape))
  del rec
  lines = generate_times(res, serve, name_limit)
  batch, model = res["batch"], res["model"]
  s = steps.prefill_length(res["cfg"], batch)

  def prefill_once():
    with torch.inference_mode():
      steps.make_prefill_step(res["cfg"], s + 2)(model, batch)

  wall, busy, top, _ = profile(prefill_once)
  simt_ms = sum(ms for name, ms, _ in top if "attention_simt" in name)
  simt_n = sum(n for name, _, n in top if "attention_simt" in name)
  share_text = (NOT_PROFILED
                if busy is None else
                f"{simt_ms:.3f} ms in {simt_n} launches of the {busy:.2f} ms "
                f"busy ({simt_ms / busy:.1%}), wall {wall:.2f} ms")
  lines.append(f"times: serve {DENSE_ARCH} f32 prefill {SERVE_BATCH}x{s}: "
               f"{SIMT}'s device time in one profiled prefill {share_text} "
               f"[{name_limit}]")
  row = {"arch": DENSE_ARCH, "dtype": "float32", "q_shape": list(shape[0]),
         "kv_shape": list(shape[1]), "launches": launches[SIMT],
         "max_abs_err": worst["max_abs_err"],
         "prefill_device_ms": None if busy is None else busy,
         "kernel_device_ms": None if busy is None else simt_ms}
  del res, model
  return launches, row, lines


# ---------------------------------------------------------------------------
# The MoE serving path (grok-1-314b at full width, 6 of 64 layers).
# ---------------------------------------------------------------------------

GROK_ARCH = "grok-1-314b"
# Depth 6 of 64: a layer holds 4.92e9 parameters (9.84 GB in bf16, the 8
# experts' 4.83e9 most of it), the embedding and the untied head 1.61e9
# together; 6 layers come to 31,130,499,072 parameters, 57.99 GiB, and 7 to
# 67.15 GiB, too close to the card's 80 GB with serving's own memory.
GROK_LAYERS = 6
GROK_PARAMS = 31_130_499_072
GROK_ARGV = ["--arch", GROK_ARCH, "--set", f"num_layers={GROK_LAYERS}",
             "--batch", str(SERVE_BATCH), "--prompt-len", str(SERVE_PROMPT),
             "--gen", str(SERVE_GEN)]
# (layers, d_model, heads, kv heads, head width, experts, top-k, expert
# width, vocabulary, soft-cap, tied): full width.
GROK_SHAPE = (GROK_LAYERS, 6144, 48, 8, 128, 8, 2, 32768, 131072, 30.0,
              False)


def grok_serve_path(dev, serve, ops, st, fa):
  """grok-1-314b's serving path once through ``serve.main`` (the command
  a user runs: ``--set num_layers=6``, random weights from seed 0) with
  every counter from 0, then its checks: the card nearly empty before the
  weights are built; every prefill launches flash_attention and the gates
  once a layer (in that order, layer by layer), every decode step
  decode_attention and the gates once a layer, no PAV kernel; the parameter count; finite
  logits within the soft-cap; gate rows summing to k; the attention kernel
  on every layer's captured prefill inputs by its error model, the gates
  bit for bit on every captured call; the same prefill on the plain
  versions.  Returns (serve result, launches, recorder, the kernels' worst
  errors on the captured inputs)."""
  held = torch.cuda.memory_allocated(dev)
  check(held < 2**30, f"{held / 2**30:.2f} GiB allocated before {GROK_ARCH}"
        "'s weights are built (at most 1 GiB)")
  ops.reset_all_launches()
  t0 = time.perf_counter()
  with Recorder(st, fa) as rec:
    res = serve.main(GROK_ARGV)
  torch.cuda.synchronize()
  launches = ops.all_launches()
  cfg = res["cfg"]
  n_layers, k, steps = cfg.num_layers, cfg.experts_per_token, SERVE_GEN - 1
  check((n_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
         cfg.head_dim, cfg.num_experts, k, cfg.moe_d_ff, cfg.vocab_size,
         cfg.logit_softcap, cfg.tie_embeddings) == GROK_SHAPE
        and cfg.router == "soft_topk" and cfg.router_eps == 1.0,
        f"{GROK_ARCH} config {cfg}")
  want = {"pav_l2": 0, "pav_kl": 0, "soft_topk_gates": n_layers * SERVE_GEN,
          "flash_attention": n_layers, "flash_attention_simt": 0,
          "decode_attention": n_layers * steps}
  order = ["attn", "gates"] * n_layers + ["gates"] * (n_layers * steps)
  check(launches == want and rec.order == order,
        f"{GROK_ARCH} serve launches {launches}, counted from the code {want}"
        "; calls by kind in order: flash_attention then the gates in each "
        "layer of the prefill, the gates alone in each layer of a decode step")
  check(all(g[0].shape == (SERVE_BATCH * SERVE_PROMPT, cfg.num_experts)
            for g in rec.gates[:n_layers])
        and all(g[0].shape == (SERVE_BATCH, cfg.num_experts)
                for g in rec.gates[n_layers:]),
        "gate calls at other shapes than (4096, 8) a prefill layer and "
        "(8, 8) a decode layer")
  say(f"serve: {GROK_ARCH} launches {launches} for 1 prefill and {steps} "
      f"decode steps of {n_layers} layers in {time.perf_counter() - t0:.1f} "
      "s with the init (counted from the code: a prefill flash_attention "
      f"and soft_topk_gates once a layer, {n_layers} each; a decode step "
      f"decode_attention and soft_topk_gates {n_layers} times each, "
      "flash_attention 0 times)")
  from repro_torch.models import transformer as T

  params = T.count_params(res["model"])
  check(params == GROK_PARAMS, f"{params} parameters, not {GROK_PARAMS}")
  for name in ("prefill_logits", "logits"):
    logits = res[name]
    check(tuple(logits.shape) == (SERVE_BATCH, cfg.vocab_size)
          and bool(torch.isfinite(logits).all())
          and float(logits.abs().max()) <= cfg.logit_softcap,
          f"{name}: not finite, or past the soft-cap {cfg.logit_softcap}")
  sums = max(float((g[3].sum(-1) - k).abs().max()) for g in rec.gates)
  check(sums <= 1e-4, f"gate row sums off k by {sums:.3e}")
  q, kx, v, _, _ = rec.attn[0]
  check(tuple(q.shape) == (SERVE_BATCH, SERVE_PROMPT, cfg.num_heads,
                           cfg.head_dim)
        and tuple(kx.shape) == tuple(v.shape)
        == (SERVE_BATCH, SERVE_PROMPT, cfg.num_kv_heads, cfg.head_dim),
        f"captured attention shapes {q.shape}, {kx.shape}, {v.shape}")
  gib = 2**30
  say(f"serve: {GROK_ARCH} {params:,} parameters at full width, "
      f"{n_layers} of 64 layers; weights {res['weights_bytes'] / gib:.3f} GiB"
      f"; peak {res['init_peak_bytes'] / gib:.3f} GiB while building them, "
      f"{res['serve_peak_bytes'] / gib:.3f} GiB while serving ({held / gib:.3f}"
      f" GiB held before); logits finite and within +-{cfg.logit_softcap}; "
      f"every gate row sums to k = {k} within {sums:.1e}")

  for logits, kk, eps, out in rec.gates:
    plain = st.soft_topk_gates_plain(logits, kk, eps)
    check(torch.equal(out, plain), "soft_topk_gates: a captured call's "
          f"gates differ from the plain version in "
          f"{int((out != plain).sum())} elements")
  worst_attn, worst_bf16 = captured_attn_checks(rec.attn, fa)
  worst = {"flash_attention 128x128": worst_attn["max_abs_err"],
           "soft_topk_gates": 0.0}
  say(f"serve: {GROK_ARCH} soft_topk_gates equal their plain version bit for"
      f" bit on all {len(rec.gates)} captured calls ({n_layers} prefill "
      f"layers at {tuple(rec.gates[0][0].shape)}, {n_layers * steps} decode"
      f" layers at {tuple(rec.gates[-1][0].shape)}); "
      f"flash_attention at (128, 128), G 6, on the captured inputs of all "
      f"{n_layers} layers, worst layer by each measure (median |ref|: the "
      f"smallest layer's), {attn_text(worst_attn, fa)}; max |kernel - plain"
      f" in bf16| {worst_bf16:.3e} (the reference's rounding, no tolerance)")
  say(plain_prefill_text(res, rec, serve, st, fa))
  return res, launches, rec, worst


def grok_serve_times(res, rec, serve, st, fa, name_limit):
  """grok-1-314b's times: the attention kernel at the prefill shape (and
  SDPA with ``enable_gqa``), the gates at (4096, 8) and (8, 8), then the
  server's prefill ms, decode rate and profiled steps."""
  gate_rows, lines = gates_times(res["cfg"], rec, st, name_limit)
  q, kx, v, causal, _ = rec.attn[0]
  row, line = attn_times(q, kx, v, causal, fa, name_limit)
  return row, gate_rows, lines + [line] + generate_times(res, serve,
                                                         name_limit)


# The decode attention kernel at the benchmark's decode cell: grok-1's (B,
# H, Hkv, D) over 6144-position caches, at the prompt's end, the window's
# reach in a 30 s run, and a full cache.
DECODE_ATTN_SHAPE = (32, 48, 8, 128, 6144)
DECODE_ATTN_LENS = (2048, 3300, 6144)
DECODE_KERNELS = ("decode_split", "decode_combine")


def decode_attn_times(dev, name_limit) -> tuple[list[dict], list[str]]:
  """``decode_attention`` at ``DECODE_ATTN_SHAPE`` (bf16, random inputs)
  for each of ``DECODE_ATTN_LENS``: held to its plain version by its error
  model, then its CUDA-event median and profiler device time (the split
  pass and the combine, 2 launches a call) beside its bound (the valid K
  and V read once, q in, o and lse out, at HBM_BYTES_PER_S), the plain
  version on the same CUDA tensors (the two einsums over the whole cache
  and the masked softmax: the main path before this kernel), and
  scaled_dot_product_attention with ``enable_gqa`` on the transposed views
  of the length-sliced caches."""
  from repro_torch.kernels import decode_attention as da

  b, h, hkv, d, s = DECODE_ATTN_SHAPE
  gen = torch.Generator(device=dev).manual_seed(s)
  q = torch.randn((b, h, d), generator=gen, device=dev, dtype=torch.bfloat16)
  k, v = (torch.randn((b, s, hkv, d), generator=gen, device=dev,
                      dtype=torch.bfloat16) for _ in range(2))
  rows, lines = [], []
  for n in DECODE_ATTN_LENS:
    o, lse = da.decode_block(q, k, v, 0, n)
    cmp = da.compare_with_plain(o, lse, q, k, v, 0, n)
    check(cmp["finite"] and cmp["tol_ratio"] <= 1.0
          and cmp["lse_ratio"] <= 1.0
          and cmp["rel_frob"] <= cmp["rel_frob_limit"],
          f"decode_attention at {DECODE_ATTN_SHAPE}, cache_len {n}: {cmp}")
    bound_ms = da.decode_bytes(q, k, 0, n) / HBM_BYTES_PER_S * 1e3
    call = lambda: da.decode_block(q, k, v, 0, n)  # noqa: E731
    ms = median_ms(call, 20)
    dev_ms = kernel_device_ms(call, DECODE_KERNELS, bound_ms=bound_ms,
                              launches=2)
    plain_ms = median_ms(lambda: da.decode_block_plain(q, k, v, 0, n), 5)
    qt = q[:, :, None]
    kt, vt = (t[:, :n].transpose(1, 2) for t in (k, v))

    def sdpa():
      torch.nn.functional.scaled_dot_product_attention(qt, kt, vt,
                                                       enable_gqa=True)

    lib_ms = median_ms(sdpa, 20)
    lib_dev_ms = kernel_device_ms(sdpa, "", bound_ms=bound_ms)
    backend = sdpa_backend(sdpa)
    plan = da.split_plan(q.dtype, b, h, hkv, d, n)
    rows.append({"shape": [b, h, hkv, d, s], "cache_len": n, "ms": ms,
                 "device_ms": dev_ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "bound_by": "bytes",
                 "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
                 "library_backend": backend, "parts": plan["parts"],
                 "part_keys": plan["part_keys"], "tol_ratio":
                 cmp["tol_ratio"], "lse_ratio": cmp["lse_ratio"]})
    lines.append(
        f"times: decode_attention q {tuple(q.shape)} caches {tuple(k.shape)}"
        f" cache_len {n} ({plan['parts']} parts of {plan['part_keys']} "
        f"keys): kernel {ms:.4f} ms (device {ms_text(dev_ms)}, profiler, "
        f"split + combine), plain {plain_ms:.4f} ms, "
        f"scaled_dot_product_attention {lib_ms:.4f} ms (device "
        f"{ms_text(lib_dev_ms)}; backend {backend}), bound {bound_ms:.5f} "
        f"ms (bytes: {da.decode_bytes(q, k, 0, n) / 1e9:.4f} GB); the bound "
        f"is {share(bound_ms, ms)} of the kernel's time "
        f"({share(bound_ms, dev_ms)} of its device time) and "
        f"{share(bound_ms, lib_ms)} of SDPA's; |err| / tol "
        f"{cmp['tol_ratio']:.4f}, lse {cmp['lse_ratio']:.4f} [{name_limit}]")
  return rows, lines


def decode_step_plain_times(res, serve, name_limit) -> str:
  """A served model's decode step (the CUDA-event median of 10 at the
  prompt's end) with ``decode_attention``'s kernel, and again with its
  plain version on the card's tensors in its place: the step before and
  after the kernel, on the same weights and caches."""
  from repro_torch.kernels import decode_attention as da
  from repro_torch.launch import steps

  cfg, batch, model = res["cfg"], res["batch"], res["model"]
  s = steps.prefill_length(cfg, batch)
  with torch.inference_mode():
    logits, caches = steps.make_prefill_step(cfg, s + 2)(model, batch)
    tok = serve.greedy(logits)
    step = lambda: steps.make_decode_step(cfg)(  # noqa: E731
        model, caches, tok, s)
    kernel_ms = median_ms(step, 10)
    block = da.decode_block
    da.decode_block = lambda q, k, v, lo, n, w=0, c=0.0: (
        da.decode_block_plain(q, k, v, lo, n, w, c))
    try:
      plain_ms = median_ms(step, 10)
    finally:
      da.decode_block = block
  del caches
  return (f"times: serve {cfg.name} decode step at position {s} (batch "
          f"{SERVE_BATCH}): {kernel_ms:.3f} ms with the decode_attention "
          f"kernel, {plain_ms:.3f} ms with its plain version in its place "
          f"(the step before the kernel) [{name_limit}]")


# ---------------------------------------------------------------------------
# The whole-model serving paths: gemma3-12b (the local / global kinds),
# stablelm-3b (LayerNorm, the GELU MLP, head width 80) and recurrentgemma-2b
# (the rg kind beside windowed MQA at G = 10), each at full width and depth.
# ---------------------------------------------------------------------------

GEMMA_ARCH = "gemma3-12b"
STABLELM_ARCH = "stablelm-3b"
RG_ARCH = "recurrentgemma-2b"
XLSTM_ARCH = "xlstm-350m"
LLAVA_ARCH = "llava-next-mistral-7b"
MUSICGEN_ARCH = "musicgen-large"
TINYLLAMA_ARCH = "tinyllama-1.1b"
LLAVA_PROMPT = 576 + SERVE_PROMPT   # --prompt-len counts the patches
# What each serve run is (``serve.main`` with --arch, the prompt length,
# --batch 8 and --gen 32): its prompt length, the config it must give ((layers, d_model, heads, kv heads, head width, FFN width,
# vocabulary, window, MLP, norm, tied): the reference's, nothing cut), its
# parameter count and its attention kernel's error key (none for xlstm,
# which has no attention layer).
# gemma's prompts are 2048 tokens and recurrentgemma's 4096: at 512 neither
# window (1024, 2048) would bind; llava's 1088 positions are 576 patch
# embeddings and 512 tokens.  Counted from the configs, and the
# reference's eval_shape gives the same: gemma3-12b 48 layers of
# 219,454,720 (attention 62,914,560, GeGLU 176,947,200, two norm scales),
# the tied 262144 x 3840 table once, the final norm; stablelm-3b 32 layers
# of 61,614,080 (attention 26,214,400, the GELU MLP 35,389,440, two
# LayerNorms of scale and bias), the table and the untied head of 50304 x
# 2560 each, the final LayerNorm; recurrentgemma-2b 18 ``rg`` layers of
# 91,768,320 (the RG-LRU block 32,780,800, GeGLU 58,982,400, two norm
# scales) and 8 ``local`` of 73,405,440 (MQA 14,417,920), the tied 256000
# x 2560 table once, the final norm; xlstm-350m 21 ``mlstm`` layers of
# 9,449,476 (the block's q, k, v, o and out 5,242,880 and f32 gates 8,196,
# the GELU MLP of 2048 4,194,304, two LayerNorms) and 3 ``slstm`` of
# 10,428,416 (w 4,194,304, r 1,048,576, b 4,096, w_out 1,048,576, GeGLU of
# 1344 4,128,768, two LayerNorms), the table and the untied head of 50304
# x 1024 each, the final LayerNorm; llava-next-mistral-7b 32 layers of
# 218,112,000 (attention 41,943,040, SwiGLU 176,160,768, two norm scales),
# the table and the untied head of 32000 x 4096 each, the final norm;
# tinyllama-1.1b 22 layers of 44,044,288 (attention 9,437,184: q and o
# 2048 x 2048, k and v 2048 x 256; SwiGLU 34,603,008; two norm scales), the
# table and the untied head of 32000 x 2048 each, the final norm.
FULL_SERVE_RUNS = {
    TINYLLAMA_ARCH: {
        "prompt": SERVE_PROMPT,
        "shape": (22, 2048, 32, 4, 64, 5632, 32000, 0, "swiglu", "rmsnorm",
                  False),
        "params": 1_100_048_384, "err_key": "flash_attention 64x64 G8"},
    GEMMA_ARCH: {
        "prompt": 2048,
        "shape": (48, 3840, 16, 8, 256, 15360, 262144, 1024, "geglu",
                  "rmsnorm", True),
        "params": 11_765_395_200, "err_key": "flash_attention 256x256"},
    STABLELM_ARCH: {
        "prompt": SERVE_PROMPT,
        "shape": (32, 2560, 32, 32, 80, 6912, 50304, 0, "gelu", "layernorm",
                  False),
        "params": 2_229_212_160, "err_key": "flash_attention 80x80"},
    RG_ARCH: {
        "prompt": 4096,
        "shape": (26, 2560, 10, 1, 256, 7680, 256000, 2048, "geglu",
                  "rmsnorm", True),
        "params": 2_894_435_840, "err_key": "flash_attention 256x256 G10"},
    XLSTM_ARCH: {
        "prompt": SERVE_PROMPT,
        "shape": (24, 1024, 4, 4, 256, 0, 50304, 0, "swiglu", "layernorm",
                  False),
        "params": 332_748_884, "err_key": None},
    LLAVA_ARCH: {
        "prompt": LLAVA_PROMPT,
        "shape": (32, 4096, 32, 8, 128, 14336, 32000, 0, "swiglu", "rmsnorm",
                  False),
        "params": 7_241_732_096, "err_key": "flash_attention 128x128 G4"},
}
# The xlstm server's prefill again on the CPU (the port's plain path, in
# bf16) for these first prompts of the batch: a whole batch would take the
# CPU tens of seconds.
XLSTM_CPU_ROWS = 2


class HeldRecorder(Recorder):
  """A Recorder that holds each attention call to the plain version as it
  is made (``held_attn``) and keeps the measures and the window, and the
  tensors of the first call of each window only: 48 layers' q, k, v and
  out at 8 x 2048 would hold 19 GB."""

  def __init__(self, st, fa):
    super().__init__(st, fa)
    self.held: list[tuple[int, dict, float]] = []   # (window, cmp, bf16)
    self.kept: dict[int, tuple] = {}                # window -> call

  def keep_attn(self, q, k, v, causal, out, window) -> None:
    self.held.append(held_attn(q, k, v, causal, out, self.fa, window))
    self.kept.setdefault(window, (q, k, v, causal, out))


# The recurrent kinds' states, by kind: the leaf that must not stay zero
# after decode (the state that carries the sequence).
RECURRENT_LIVE = {"rg": "h", "mlstm": "c", "slstm": "h"}


def recurrent_states_after_decode(res, serve) -> str:
  """The prompts served again as ``generate`` serves them (prefill, then
  31 greedy decode steps), keeping the caches: every recurrent layer's
  state after the last step (rg h and conv; mlstm C, n and m; slstm c, n,
  m and h) is finite and f32, its live leaf not zero; and the tokens
  against the first run's."""
  from repro_torch.launch import steps

  cfg, model, batch = res["cfg"], res["model"], res["batch"]
  s = steps.prefill_length(cfg, batch)
  decode = steps.make_decode_step(cfg)
  with torch.inference_mode():
    logits, caches = steps.make_prefill_step(cfg, s + SERVE_GEN)(model,
                                                                 batch)
    tokens = [serve.greedy(logits)]
    for i in range(SERVE_GEN - 1):
      logits, caches = decode(model, caches, tokens[-1], s + i)
      tokens.append(serve.greedy(logits))
  parts = []
  for kind, live in RECURRENT_LIVE.items():
    states = [c for c, k in zip(caches, cfg.layer_kinds()) if k == kind]
    if not states:
      continue
    check(all(t.dtype == torch.float32 and bool(torch.isfinite(t).all())
              for c in states for t in c.values())
          and all(bool((c[live] != 0).any()) for c in states),
          f"a {kind} layer's state after decode is not finite f32")
    top = max(float(c[live].abs().max()) for c in states)
    shapes = ", ".join(f"{k} {tuple(t.shape)}" for k, t in states[0].items())
    parts.append(f"the {len(states)} {kind} layers' ({shapes}) finite f32, "
                 f"{live} non-zero (max |{live}| {top:.3e})")
  same = int((torch.stack(tokens, 1) == res["tokens"]).all(-1).sum())
  return (f"serve: {cfg.name} after prefill and {SERVE_GEN - 1} decode "
          f"steps every recurrent state is checked: {'; '.join(parts)}; "
          f"the run again generated the first run's tokens in {same} of "
          f"{res['prompts'].shape[0]} rows")


def rel_frob(a: torch.Tensor, b: torch.Tensor) -> float:
  """||a - b||_F / ||b||_F in f64."""
  a, b = a.double(), b.double()
  return float(torch.linalg.vector_norm(a - b)
               / max(float(torch.linalg.vector_norm(b)), 1e-30))


# The limit on the relative Frobenius error of one xLSTM layer's output
# and state on the CPU against the card's, from the same input: bf16 holds
# 2^-9 relative; an mLSTM layer's normalization by sums of signed terms
# amplifies a rounding some tens of times (the port's tests measured up to
# ~28x at smoke size), so 2^-4 passes rounding and fails a wrong layer.
XLSTM_LAYER_LIMIT = 2.0**-4


def cpu_layers_text(res) -> str:
  """The xlstm server's prefill checked against the CPU (the port's plain
  path, in the same dtype) for the first ``XLSTM_CPU_ROWS`` prompts.
  With random weights this model amplifies one bf16 rounding into O(1)
  logits end to end: the card's own prefill with its embedding table
  perturbed by one rounding (a relative 2^-8 of random sign) shows the
  spread.  So the CPU is held to the card layer by layer, each layer on a
  CPU copy from the card's input to it: its output and its state
  (relative Frobenius error, limit ``XLSTM_LAYER_LIMIT``).  End to end,
  the whole prefill again on the CPU: the logit difference and the first
  token's agreement, beside that spread."""
  import copy

  from repro_torch.launch import steps
  from repro_torch.models import transformer as T

  cfg, model = res["cfg"], res["model"]
  rows = {k: v[:XLSTM_CPU_ROWS] for k, v in res["batch"].items()}
  s = steps.prefill_length(cfg, rows)
  t0 = time.perf_counter()
  worst_out, worst_state = 0.0, 0.0
  with torch.inference_mode():
    x = T.embed_inputs(cfg, model, rows)
    for layer in model.layers:
      out, _, st = layer.apply_seq(x, torch.arange(s, device=x.device),
                                   collect_cache=True)
      host = copy.deepcopy(layer).cpu()
      out_c, _, st_c = host.apply_seq(x.cpu(), torch.arange(s),
                                      collect_cache=True)
      worst_out = max(worst_out, rel_frob(out.cpu(), out_c))
      worst_state = max(worst_state, max(rel_frob(st[k].cpu(), st_c[k])
                                         for k in st))
      x = out
    check(worst_out <= XLSTM_LAYER_LIMIT and worst_state <= XLSTM_LAYER_LIMIT,
          f"xlstm layer on the CPU vs the card: output {worst_out:.3e}, "
          f"state {worst_state:.3e} (limit {XLSTM_LAYER_LIMIT:.3e})")
    host = copy.deepcopy(model).cpu()
    logits, _ = steps.make_prefill_step(cfg)(
        host, {k: v.cpu() for k, v in rows.items()})
    del host
    card = res["prefill_logits"][:XLSTM_CPU_ROWS].cpu()
    table = model.embed.table
    saved = table.clone()
    gen = torch.Generator(device=table.device).manual_seed(SEED)
    sign = torch.randint(0, 2, table.shape, generator=gen,
                         device=table.device).to(table.dtype) * 2 - 1
    table.mul_(1 + 2.0**-8 * sign)
    spread, _ = steps.make_prefill_step(cfg)(model, rows)
    table.copy_(saved)
    del saved, sign
  seconds = time.perf_counter() - t0
  check(bool(torch.isfinite(logits).all()), "CPU prefill logits not finite")
  dl = float((card - logits).abs().max())
  ds = float((card - spread.cpu()).abs().max())
  agree = int((card.argmax(-1) == logits.argmax(-1)).sum())
  return (f"serve: {cfg.name} card vs CPU (plain path, {cfg.dtype}) on the "
          f"first {XLSTM_CPU_ROWS} prompts: every one of the "
          f"{cfg.num_layers} layers from the card's input to it, relative "
          f"Frobenius error of the output at most {worst_out:.3e}, of the "
          f"state {worst_state:.3e} (limit {XLSTM_LAYER_LIMIT:.3e}); end to "
          f"end the last-position logits differ by at most {dl:.3e} (max "
          f"|logit| {float(logits.abs().max()):.3e}), the first greedy "
          f"token agrees in {agree} of {XLSTM_CPU_ROWS} rows, while one "
          f"rounding of the embedding table moves the card's own logits by "
          f"{ds:.3e}; {seconds:.1f} s")


def cache_shapes(cfg, kind: str, batch: int, max_len: int) -> dict:
  """The cache a layer of ``kind`` must hold: k / v full length for
  attention, the recurrent kinds' states whatever ``max_len``."""
  width, dh = cfg.lru_width or cfg.d_model, cfg.d_model // cfg.num_heads
  h = cfg.num_heads
  if kind == "rg":
    return {"h": (batch, width), "conv": (batch, cfg.conv_width - 1, width)}
  if kind == "mlstm":
    return {"c": (batch, h, cfg.head_dim, cfg.head_dim),
            "n": (batch, h, cfg.head_dim), "m": (batch, h)}
  if kind == "slstm":
    return dict.fromkeys("cnmh", (batch, h, dh))
  return dict.fromkeys(("k", "v"), (batch, max_len, cfg.num_kv_heads,
                                    cfg.head_dim))


def full_serve_path(dev, serve, ops, st, fa, arch: str):
  """A serve run of ``FULL_SERVE_RUNS`` once through ``serve.main`` (the
  command a user runs; random weights from seed 0, 8 prompts, 32
  generated) with every counter from 0, then its checks: the config as the
  reference has it; a prefill launches flash_attention once an attention
  layer, in the layers' order, with the window of each (gemma: 48, 40 of
  them ``local`` under its window of 1024; stablelm: 32, none windowed;
  recurrentgemma: its 8 ``local`` layers under the window of 2048, its
  ``rg`` layers none; xlstm: none, its ``mlstm`` and ``slstm`` layers are
  PyTorch ops; llava: 32 over its 576 patches and 512 tokens), a decode
  step decode_attention once an attention layer, no gate and no PAV
  kernel; every attention layer's cache full length and every
  recurrent state its shape; the parameter count, the head tied or not;
  finite logits; the kernel held to its error model on every attention
  layer's inputs as it ran (the worst by window); every recurrent state
  after decode; the same prefill on the plain versions (for xlstm, which
  has no kernel, on the CPU).  Returns (serve result, launches, recorder,
  the kernel's worst error by key)."""
  from repro_torch.models import transformer as T

  run = FULL_SERVE_RUNS[arch]
  held = torch.cuda.memory_allocated(dev)
  check(held < 2**30, f"{held / 2**30:.2f} GiB allocated before {arch}'s "
        "weights are built (at most 1 GiB)")
  ops.reset_all_launches()
  t0 = time.perf_counter()
  with HeldRecorder(st, fa) as rec:
    res = serve.main(["--arch", arch, "--batch", str(SERVE_BATCH),
                      "--prompt-len", str(run["prompt"]), "--gen",
                      str(SERVE_GEN)])
  torch.cuda.synchronize()
  launches = ops.all_launches()
  cfg = res["cfg"]
  check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
         cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.window_size,
         cfg.mlp_variant, cfg.norm, cfg.tie_embeddings) == run["shape"],
        f"{arch} config {cfg}")
  kinds = cfg.layer_kinds()
  windows = [cfg.window_size if kind == "local" else 0 for kind in kinds
             if T.MIXERS[kind] == "attn"]
  want = {"pav_l2": 0, "pav_kl": 0, "soft_topk_gates": 0,
          "flash_attention": len(windows), "flash_attention_simt": 0,
          "decode_attention": len(windows) * (SERVE_GEN - 1)}
  check(launches == want and [w for w, _, _ in rec.held] == windows
        and not rec.gates,
        f"{arch} serve launches {launches}, windows "
        f"{[w for w, _, _ in rec.held]}; counted from the code {want}, "
        f"windows {windows}")
  n_local = kinds.count("local")
  counted = [f"{len(windows) - n_local} without a window"] if windows else []
  if n_local:
    counted.insert(0, f"{n_local} under the window of {cfg.window_size}")
  for kind in T.RECURRENT:
    if kind in kinds:
      counted.append(f"none in the {kinds.count(kind)} {kind} layers")
  say(f"serve: {arch} launches {launches} for 1 prefill and "
      f"{SERVE_GEN - 1} decode steps of {cfg.num_layers} layers in "
      f"{time.perf_counter() - t0:.1f} s with the init and the held checks "
      f"(counted from the code: flash_attention once an attention layer a "
      f"prefill, {', '.join(counted)}; decode_attention once an attention "
      "layer a decode step; nothing else)")

  params = T.count_params(res["model"])
  check(params == run["params"], f"{params} parameters, not {run['params']}")
  check(hasattr(res["model"], "lm_head") != cfg.tie_embeddings,
        "the head does not match tie_embeddings")
  for name in ("prefill_logits", "logits"):
    logits = res[name]
    check(tuple(logits.shape) == (SERVE_BATCH, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), f"{name}: not finite")
  prompt = run["prompt"]
  for q, kx, v, _, _ in rec.kept.values():
    check(tuple(q.shape) == (SERVE_BATCH, prompt, cfg.num_heads,
                             cfg.head_dim)
          and tuple(kx.shape) == tuple(v.shape)
          == (SERVE_BATCH, prompt, cfg.num_kv_heads, cfg.head_dim),
          f"captured attention shapes {q.shape}, {kx.shape}, {v.shape}")
  caches = T.init_cache(cfg, SERVE_BATCH, prompt + SERVE_GEN, "meta")
  check(all({k: tuple(t.shape) for k, t in c.items()} == cache_shapes(
      cfg, kind, SERVE_BATCH, prompt + SERVE_GEN)
            for c, kind in zip(caches, kinds)),
        "a layer's cache is not full length, or a state not its shape")
  cache_bytes = sum(t.numel() * t.element_size() for c in caches
                    for t in c.values())
  gib = 2**30
  head = "the tied table once" if cfg.tie_embeddings else "an untied head"
  prompt_text = (f"{prompt} positions: {cfg.num_patches} patches and "
                 f"{prompt - cfg.num_patches} tokens"
                 if cfg.frontend == "vision" else f"{prompt} tokens")
  say(f"serve: {arch} {params:,} parameters ({head}), all {cfg.num_layers} "
      f"layers at full width; prompts of {prompt_text}; weights "
      f"{res['weights_bytes'] / gib:.3f} GiB; caches {cache_bytes / gib:.3f}"
      f" GiB (every attention layer's full length, {prompt + SERVE_GEN} "
      f"positions, and the recurrent states); peak "
      f"{res['init_peak_bytes'] / gib:.3f} GiB while building the weights, "
      f"{res['serve_peak_bytes'] / gib:.3f} GiB while serving with the held "
      f"checks ({held / gib:.3f} GiB held before); logits finite")
  worst = 0.0
  for window in sorted(set(windows)):
    worst_attn, worst_bf16 = worst_of([c for c in rec.held
                                       if c[0] == window])
    worst = max(worst, worst_attn["max_abs_err"])
    say(f"serve: {arch} flash_attention at ({cfg.head_dim}, "
        f"{cfg.head_dim}), G {cfg.num_heads // cfg.num_kv_heads}, on all "
        f"{windows.count(window)} layers' inputs "
        + (f"under the window of {window}" if window else "without a window")
        + ", worst layer by each measure (median |ref|: the smallest "
        f"layer's), {attn_text(worst_attn, fa)}; max |kernel - plain in "
        f"bf16| {worst_bf16:.3e} (the reference's rounding, no tolerance)")
  if any(kind in T.RECURRENT for kind in kinds):
    say(recurrent_states_after_decode(res, serve))
  if windows:
    say(plain_prefill_text(res, rec, serve, st, fa))
  else:
    say(cpu_layers_text(res))
  return res, launches, rec, ({run["err_key"]: worst} if run["err_key"]
                              else {})


def full_serve_times(res, rec, serve, fa, dev, name_limit):
  """A ``full_serve_path`` run's times: the attention kernel at the first
  captured prefill inputs of each window (SDPA ``is_causal``, with
  ``enable_gqa`` where G > 1, or with a boolean band mask under a window),
  then the server's prefill ms, decode rate, peak memory over those runs
  and profiled steps (with the sLSTM scan's share for xlstm).  Returns the
  row of the smallest window (gemma's global layers, stablelm's and
  llava's only, recurrentgemma's local; none for xlstm), and where a model
  has two the windowed one under ``local``."""
  lines, rows = [], {}
  for window, (q, kx, v, causal, _) in sorted(rec.kept.items()):
    rows[window], line = attn_times(q, kx, v, causal, fa, name_limit, window)
    lines.append(line)
  row = None
  if rows:
    first, *windowed = sorted(rows)
    row = rows[first]
    if windowed:
      local = rows[windowed[0]]
      if row["device_ms"] and local["device_ms"]:
        lines.append(f"times: flash_attention at {tuple(row['width'])}: "
                     f"the window of {windowed[0]} takes "
                     f"{local['device_ms'] / row['device_ms']:.1%} of the "
                     f"unwindowed layers' device time, for "
                     f"{local['bound_ms'] / row['bound_ms']:.1%} of the "
                     f"bound [{name_limit}]")
      row = {**row, "local": local,
             "windowed_launches": sum(1 for w, _, _ in rec.held if w)}
  rec.kept.clear()
  gc.collect()
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats(dev)
  lines += generate_times(res, serve, name_limit)
  peak = torch.cuda.max_memory_allocated(dev) / 2**30
  lines.append(f"times: serve {res['cfg'].name} peak memory over the timed "
               f"runs and profiles {peak:.3f} GiB [{name_limit}]")
  if res["cfg"].name == GEMMA_ARCH:
    lines.append(decode_step_plain_times(res, serve, name_limit))
  return row, lines


# musicgen-large, served at the steps' level (the reference's server
# refuses audio: its decode takes frame embeddings): the pipeline's audio
# branch gives 8 x (512 + 31) frame embeddings; the first 512 of each row
# are the prompt, the rest feed the 31 decode steps.  Counted from the
# config: 48 layers of 50,339,840 (attention 16,777,216, the GELU MLP
# 33,554,432, two LayerNorms of scale and bias), four 2048 x 2048 codebook
# heads, the final LayerNorm, no embedding: 2,433,093,632.
MUSICGEN_SHAPE = (48, 2048, 32, 32, 64, 8192, 2048, "gelu", "layernorm", 4)
MUSICGEN_PARAMS = 2_433_093_632


def audio_generate(cfg, model, frames: torch.Tensor, prompt: int) -> dict:
  """Prefill ``frames[:, :prompt]`` (B, S, d), then decode one step a
  further frame, ``frames[:, prompt + i]`` at position ``prompt + i``,
  through ``launch/steps.py``'s step builders (the device synchronised
  around each phase).  Returns the prefill logits (B, 4, V), the last
  step's, each step's greedy codes (B, steps + 1, 4) and the wall times."""
  from repro_torch.launch import steps

  gen = frames.shape[1] - prompt + 1
  prefill = steps.make_prefill_step(cfg, prompt + gen)
  decode = steps.make_decode_step(cfg)
  with torch.inference_mode():
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill_logits, caches = prefill(model, {"embeds": frames[:, :prompt]})
    codes = [prefill_logits.argmax(-1)]
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    logits = prefill_logits
    t0 = time.perf_counter()
    for i in range(gen - 1):
      logits, caches = decode(model, caches, frames[:, prompt + i],
                              prompt + i)
      codes.append(logits.argmax(-1))
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
  return {"prefill_logits": prefill_logits, "logits": logits,
          "codes": torch.stack(codes, 1), "prefill_s": t_prefill,
          "decode_s": t_decode}


def audio_serve_path(dev, ops, st, fa):
  """musicgen-large whole at the steps' level: ``T.init_params`` on the
  card from seed 0 (4.53 GiB), the pipeline's frames, then
  ``audio_generate`` with every counter from 0.  Checks: the config; a
  prefill launches flash_attention once a layer (48, at (64, 64), G 1), a
  decode step none, nothing else; finite (8, 4, 2048) logits; the kernel
  held to its error model on every layer's inputs as it ran; the
  parameter count with no embedding and four codebook heads; the same
  prefill on the plain versions.  Returns (result, launches, recorder,
  the kernel's worst error)."""
  from repro_torch.configs.base import get_config
  from repro_torch.data.pipeline import pipeline_for_arch
  from repro_torch.models import transformer as T

  held = torch.cuda.memory_allocated(dev)
  check(held < 2**30, f"{held / 2**30:.2f} GiB allocated before "
        f"{MUSICGEN_ARCH}'s weights are built (at most 1 GiB)")
  cfg = get_config(MUSICGEN_ARCH)
  check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
         cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.mlp_variant, cfg.norm,
         cfg.num_codebooks) == MUSICGEN_SHAPE, f"{MUSICGEN_ARCH} {cfg}")
  torch.cuda.reset_peak_memory_stats(dev)
  t0 = time.perf_counter()
  model = T.init_params(cfg, SEED, dev)
  torch.cuda.synchronize()
  init_peak = torch.cuda.max_memory_allocated(dev)
  weights = sum(p.numel() * p.element_size() for p in model.parameters())
  pipe = pipeline_for_arch(cfg, SERVE_BATCH, SERVE_PROMPT + SERVE_GEN - 1,
                           seed=SEED)
  frames = torch.from_numpy(pipe.batch_at(0)["embeds"]).to(dev)
  say(f"serve: {MUSICGEN_ARCH} initialised on the card in "
      f"{time.perf_counter() - t0:.1f} s; frames {tuple(frames.shape)} "
      "from the pipeline's audio branch")
  torch.cuda.reset_peak_memory_stats(dev)
  ops.reset_all_launches()
  with HeldRecorder(st, fa) as rec:
    res = audio_generate(cfg, model, frames, SERVE_PROMPT)
  torch.cuda.synchronize()
  launches = ops.all_launches()
  serve_peak = torch.cuda.max_memory_allocated(dev)
  want = {"pav_l2": 0, "pav_kl": 0, "soft_topk_gates": 0,
          "flash_attention": cfg.num_layers, "flash_attention_simt": 0,
          "decode_attention": cfg.num_layers * (SERVE_GEN - 1)}
  check(launches == want and len(rec.held) == cfg.num_layers
        and not rec.gates, f"{MUSICGEN_ARCH} launches {launches}, counted "
        f"from the code {want}")
  say(f"serve: {MUSICGEN_ARCH} launches {launches} for 1 prefill of "
      f"{SERVE_PROMPT} frames and {SERVE_GEN - 1} decode steps of "
      f"{cfg.num_layers} layers (counted from the code: flash_attention "
      "once a layer a prefill, decode_attention once a layer a decode step, "
      "nothing else)")
  params = T.count_params(model)
  check(params == MUSICGEN_PARAMS and not hasattr(model, "embed")
        and len(model.codebook_heads()) == 4,
        f"{params} parameters, not {MUSICGEN_PARAMS}")
  for name in ("prefill_logits", "logits"):
    logits = res[name]
    check(tuple(logits.shape) == (SERVE_BATCH, 4, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), f"{name}: not finite")
  q, kx, v, _, _ = rec.kept[0]
  check(tuple(q.shape) == tuple(kx.shape) == tuple(v.shape)
        == (SERVE_BATCH, SERVE_PROMPT, cfg.num_heads, cfg.head_dim),
        f"captured attention shapes {q.shape}, {kx.shape}, {v.shape}")
  gib = 2**30
  say(f"serve: {MUSICGEN_ARCH} {params:,} parameters (no embedding, four "
      f"codebook heads), all {cfg.num_layers} layers at full width; weights "
      f"{weights / gib:.3f} GiB; peak {init_peak / gib:.3f} GiB while "
      f"building them, {serve_peak / gib:.3f} GiB while serving with the "
      f"held checks; logits {tuple(res['logits'].shape)} finite")
  worst_attn, worst_bf16 = worst_of(rec.held)
  say(f"serve: {MUSICGEN_ARCH} flash_attention at (64, 64), G 1, on all "
      f"{cfg.num_layers} layers' inputs, worst layer by each measure "
      f"(median |ref|: the smallest layer's), {attn_text(worst_attn, fa)}; "
      f"max |kernel - plain in bf16| {worst_bf16:.3e} (the reference's "
      "rounding, no tolerance)")
  with Recorder(st, fa, plain=True, tensors=False) as plain_rec:
    plain = audio_generate(cfg, model, frames[:, :SERVE_PROMPT + 1],
                           SERVE_PROMPT)
  check(len(plain_rec.attn) == cfg.num_layers,
        "the plain prefill did not pass every layer")
  dl = float((res["prefill_logits"] - plain["prefill_logits"]).abs().max())
  agree = float((res["codes"][:, 0] == plain["codes"][:, 0]).float().mean())
  say(f"serve: {MUSICGEN_ARCH} kernel-path vs plain-path prefill: "
      f"last-position logits differ by at most {dl:.3e} (max |logit| "
      f"{float(plain['prefill_logits'].abs().max()):.3e}); the first "
      f"greedy code agrees in {agree:.1%} of the {SERVE_BATCH} x 4 rows and "
      "codebooks")
  res.update(cfg=cfg, model=model, frames=frames, weights_bytes=weights,
             init_peak_bytes=init_peak, serve_peak_bytes=serve_peak)
  return res, launches, rec, {"flash_attention 64x64 G1":
                              worst_attn["max_abs_err"]}


def audio_serve_times(res, rec, fa, dev, name_limit):
  """musicgen's times: the attention kernel at the prefill's inputs (SDPA
  ``is_causal``, G 1), then the prefill ms and decode frames/s over 3
  more runs (each giving the first run's codes), the peak over them, and
  a profiled prefill and decode step."""
  from repro_torch.launch import steps

  q, kx, v, causal, _ = rec.kept[0]
  row, line = attn_times(q, kx, v, causal, fa, name_limit)
  lines = [line]
  rec.kept.clear()
  gc.collect()
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats(dev)
  cfg, model, frames = res["cfg"], res["model"], res["frames"]
  prefill, decode, same = [], [], 0
  for _ in range(3):
    again = audio_generate(cfg, model, frames, SERVE_PROMPT)
    same += int(torch.equal(again["codes"], res["codes"]))
    prefill.append(again["prefill_s"] * 1e3)
    decode.append((SERVE_GEN - 1) * SERVE_BATCH / again["decode_s"])
  state = {}

  def prefill_once():
    with torch.inference_mode():
      state["logits"], state["caches"] = steps.make_prefill_step(
          cfg, SERVE_PROMPT + 2)(model, {"embeds": frames[:, :SERVE_PROMPT]})

  def decode_once():
    with torch.inference_mode():
      steps.make_decode_step(cfg)(model, state["caches"],
                                  frames[:, SERVE_PROMPT], SERVE_PROMPT)

  for name, fn in (("prefill", prefill_once), ("decode step", decode_once)):
    lines.append(profile_line(cfg, name, fn, name_limit))
  peak = torch.cuda.max_memory_allocated(dev) / 2**30
  lines.append(f"times: serve {cfg.name}: {same} of 3 timed runs gave the "
               f"first run's codes; prefill {SERVE_BATCH}x{SERVE_PROMPT} "
               f"frames {statistics.median(prefill):.2f} ms (runs "
               f"{', '.join(f'{t:.2f}' for t in prefill)}), decode "
               f"{statistics.median(decode):.1f} frames/s at batch "
               f"{SERVE_BATCH}, 4 codes each (runs "
               f"{', '.join(f'{t:.1f}' for t in decode)}); peak memory over "
               f"the timed runs and profiles {peak:.3f} GiB [{name_limit}]")
  return row, lines


# ---------------------------------------------------------------------------
# The training paths: deepseek-v2-lite-16b at full width, 4 of 27 layers,
# llama3.2-1b and tinyllama-1.1b at full width and depth, and the rest of
# ``TRAIN_RUNS``.
# ---------------------------------------------------------------------------

# Depth 4 of 27 for deepseek: the trainer keeps about 16 bytes a parameter
# (bf16 weights and gradients, f32 AdamW moments, f32 gradient
# accumulators), about 260 GB at the full depth's 16.21e9 parameters and
# 44 GB at 4 layers (2.76e9).  Width, grad_accum 8 and remat "full" are the
# config's.  llama3.2-1b runs whole: 1.236e9 parameters, about 20 GB of
# state, the config's grad_accum 4 (microbatches of 2 x 2048) and remat
# "full".  tinyllama-1.1b runs whole too: 1.100e9 parameters, about 17.6
# GB of state, the config's grad_accum 4 (microbatches of 2 x 2048, the
# kernel at G 8) and remat "full".  gemma3-12b at full width, cut to one
# block cycle of 6 layers (5
# local, 1 global): 2.35e9 parameters, about 38 GB of state at 16 bytes a
# parameter (48 layers would be 188 GB), the config's grad_accum 8
# (microbatches of 1 x 2048) and remat "full"; its first attention call is
# a local layer's, under the window.  stablelm-3b runs whole: 2.23e9
# parameters, about 36 GB of state, the config's grad_accum 8 and remat
# "full".  recurrentgemma-2b runs its checks only, at full width and one
# block cycle (rg, rg, local): 0.91e9 parameters, about 15 GB of state, 2
# steps, its attention call (the local layer's) under the window of 2048,
# which at 2048 positions keeps every key; no times.  llama3.2-1b runs
# whole once more under remat "dots" (``DOTS_RUN``), 2 steps and 1 more
# timed: step ms and peak memory only, its first step's microbatch losses
# held to the "full" run's.
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 8, 2048, 4
RG_TRAIN_STEPS = 2
# xlstm-350m's step runs its 3 sLSTM scans position by position, about
# 2.7 x 10^6 eager launches and 35-66 s a step on the card (``PERF.md``
# §5): one step, timed (no more steps), and its profile one microbatch of
# the 8.  (Two steps took the script past 1000 s on a slow host.)
XLSTM_TRAIN_STEPS = 1
DOTS_STEPS = 2
TRAIN_COMMON = ["--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                "--trim-frac", "0.1", "--corrupt", "0.1"]
STEPS = ["--steps", str(TRAIN_STEPS)]
EXPERT_LEAF = "layers.0.params.ffn.we_in"     # (64, 2048, 1408) bf16
# What each train run is: its command line, the config it must give
# (layers, d_model, grad_accum, remat, dtype), the leaf whose AdamW update
# is checked card against CPU, the attention shapes one microbatch gives
# the kernel (q, v) and its first call's window (0 where absent), its
# depth as printed, and, where they differ from the rule, its steps and
# whether it is timed ("steps": the step ms and peak only; False: only the
# attention at the training shape), or the run whose first step's losses
# it must give ("same_losses_as").
DOTS_RUN = f"{DENSE_ARCH} remat=dots"
TRAIN_RUNS = {
    ARCH: {
        "args": ["--arch", ARCH, "--set", f"num_layers={TRAIN_LAYERS}",
                 *TRAIN_COMMON, *STEPS],
        "config": (TRAIN_LAYERS, 2048, 8, "full", "bfloat16"),
        "leaf": EXPERT_LEAF,
        "attn": ((1, TRAIN_SEQ, 16, 192), (1, TRAIN_SEQ, 16, 128)),
        "depth": f"{TRAIN_LAYERS} of 27 layers"},
    DENSE_ARCH: {
        "args": ["--arch", DENSE_ARCH, *TRAIN_COMMON, *STEPS],
        "config": (16, 2048, 4, "full", "bfloat16"),
        "leaf": "layers.0.params.ffn.w_in",      # (2048, 8192) bf16
        "attn": ((2, TRAIN_SEQ, 32, 64), (2, TRAIN_SEQ, 8, 64)),
        "depth": "all 16 layers"},
    DOTS_RUN: {
        "args": ["--arch", DENSE_ARCH, "--set", "remat=dots",
                 *TRAIN_COMMON, "--steps", str(DOTS_STEPS)],
        "config": (16, 2048, 4, "dots", "bfloat16"),
        "leaf": "layers.0.params.ffn.w_in",
        "attn": ((2, TRAIN_SEQ, 32, 64), (2, TRAIN_SEQ, 8, 64)),
        "depth": "all 16 layers",
        "steps": DOTS_STEPS, "timed": "steps", "timed_steps": 1,
        "same_losses_as": DENSE_ARCH},
    TINYLLAMA_ARCH: {
        "args": ["--arch", TINYLLAMA_ARCH, *TRAIN_COMMON, *STEPS],
        "config": (22, 2048, 4, "full", "bfloat16"),
        "leaf": "layers.0.params.ffn.w_in",      # (2048, 5632) bf16
        "attn": ((2, TRAIN_SEQ, 32, 64), (2, TRAIN_SEQ, 4, 64)),
        "depth": "all 22 layers"},
    GEMMA_ARCH: {
        "args": ["--arch", GEMMA_ARCH, "--set", "num_layers=6",
                 *TRAIN_COMMON, *STEPS],
        "config": (6, 3840, 8, "full", "bfloat16"),
        "leaf": "layers.0.params.ffn.w_in",      # (3840, 15360) bf16
        "attn": ((1, TRAIN_SEQ, 16, 256), (1, TRAIN_SEQ, 8, 256)),
        "window": 1024,
        "depth": "6 of 48 layers (one 5:1 cycle)"},
    STABLELM_ARCH: {
        "args": ["--arch", STABLELM_ARCH, *TRAIN_COMMON, *STEPS],
        "config": (32, 2560, 8, "full", "bfloat16"),
        "leaf": "layers.0.params.ffn.w_in",      # (2560, 6912) bf16
        "attn": ((1, TRAIN_SEQ, 32, 80), (1, TRAIN_SEQ, 32, 80)),
        "depth": "all 32 layers"},
    RG_ARCH: {
        "args": ["--arch", RG_ARCH, "--set", "num_layers=3", *TRAIN_COMMON,
                 "--steps", str(RG_TRAIN_STEPS)],
        "config": (3, 2560, 8, "full", "bfloat16"),
        "leaf": "layers.0.params.rg.w_x",        # (2560, 2560) bf16
        "attn": ((1, TRAIN_SEQ, 10, 256), (1, TRAIN_SEQ, 1, 256)),
        "window": 2048,
        "depth": "3 of 26 layers (one rg, rg, local cycle)",
        "steps": RG_TRAIN_STEPS, "timed": False},
    XLSTM_ARCH: {
        "args": ["--arch", XLSTM_ARCH, *TRAIN_COMMON, "--steps",
                 str(XLSTM_TRAIN_STEPS)],
        "config": (24, 1024, 8, "full", "bfloat16"),
        "leaf": "layers.7.params.slstm.r",       # (4, 256, 4, 256) bf16
        "attn": None,
        "depth": "all 24 layers",
        "steps": XLSTM_TRAIN_STEPS, "timed_steps": 0,
        "profile": "microbatch"},
    MUSICGEN_ARCH: {
        "args": ["--arch", MUSICGEN_ARCH, *TRAIN_COMMON, *STEPS],
        "config": (48, 2048, 8, "full", "bfloat16"),
        "leaf": "codebook_head_0.w",             # (2048, 2048) bf16
        "attn": ((1, TRAIN_SEQ, 32, 64), (1, TRAIN_SEQ, 32, 64)),
        "depth": "all 48 layers"},
    LLAVA_ARCH: {
        "args": ["--arch", LLAVA_ARCH, "--set", "num_layers=4",
                 *TRAIN_COMMON, "--steps", str(RG_TRAIN_STEPS)],
        "config": (4, 4096, 8, "full", "bfloat16"),
        "leaf": "layers.0.params.ffn.w_in",      # (4096, 14336) bf16
        "attn": ((1, TRAIN_SEQ, 32, 128), (1, TRAIN_SEQ, 8, 128)),
        "depth": "4 of 32 layers",
        "steps": RG_TRAIN_STEPS, "timed": False},
}
TRAIN_RANGES = ("repro_forward_train", "repro_soft_lts_loss",
                "repro_optimizer_update")
# Kernel kinds of a train step's profile, by substrings of their names
# (the first group that matches); the rest is "other".
KERNEL_GROUPS = {
    "attention kernel": ("flash_kernel",),
    "PAV kernel": ("L2Algebra", "KlAlgebra"),
    "GEMM (cuBLAS nvjet)": ("nvjet",),
    "GEMM (other, f32 xmma among them)": ("gemm", "xmma"),
    "elementwise": ("elementwise",),
    "reductions and scans": ("reduce", "scan", "softmax", "norm"),
    "index, gather, scatter, sort": ("index", "gather", "scatter", "sort",
                                     "embedding", "Radix"),
    "copies": ("copy", "Memcpy", "Memset", "cat"),
    "other": (),
}


def train_launches_per_step(cfg) -> dict[str, int]:
  """Kernel launches of one train step, counted from the code, by layer
  kind: each of the ``grad_accum`` microbatches runs every layer's
  forward twice (remat "full" and "dots": once, and again in backward;
  "dots" keeps only the products' outputs, and the attention kernel is
  not one), each pass launching attention once a layer, and, in an MoE layer with the soft
  top-k router (``mla_moe`` here), ``pav_l2`` once (``soft_topk_mask``
  over the microbatch's tokens, one row each, fewer than 65535); a dense
  layer launches no PAV kernel.  The soft-LTS loss sorts each
  microbatch's tokens as one row in one more ``pav_l2`` launch.  The fused
  gates and ``pav_kl`` do not run under autograd; a recurrent layer
  (``rg``, ``mlstm``, ``slstm``) launches no kernel."""
  passes = cfg.grad_accum * (1 if cfg.remat == "none" else 2)
  kinds = cfg.layer_kinds()
  n_attn = attention_layers(cfg)
  routed = (sum(kind == "mla_moe" for kind in kinds)
            if cfg.router == "soft_topk" else 0)
  trim = cfg.grad_accum if cfg.loss_trim_fraction > 0 else 0
  return {"pav_l2": passes * routed + trim, "pav_kl": 0,
          "soft_topk_gates": 0, "flash_attention": passes * n_attn,
          "flash_attention_simt": 0, "decode_attention": 0}


class TrainRecorder:
  """Wraps, for the train run, the functions the train step calls through
  their modules, and calls through to each: ``steps.loss_from_batch`` (every
  microbatch's loss), ``adamw.update`` (the first step's gradients, finite
  and non-zero on every leaf or not; the launch counts at each step's end;
  each step's metrics; the last step's inputs and result on the leaf
  ``leaf``), the attention wrapper (the first call's q, k, v, causal flag
  and window) and the router's ``soft_topk_mask`` (the first call's
  logits, if any)."""

  def __init__(self, ops, steps, adamw, fa, moe, leaf: str):
    self.ops, self.steps, self.adamw, self.fa, self.moe = (
        ops, steps, adamw, fa, moe)
    self.leaf_name = leaf
    self.losses: list[float] = []
    self.grad_faults: list[str] | None = None
    self.n_leaves = 0
    self.step_launches: list[dict[str, int]] = []
    self.step_metrics: list[dict[str, float]] = []
    self.leaf: dict = {}
    self.attn: tuple | None = None
    self.logits: tuple | None = None

  def __enter__(self):
    self._orig = (self.steps.loss_from_batch, self.adamw.update,
                  self.fa.flash_attention, self.moe.soft_topk_mask)
    loss_fn, update, attn, mask = self._orig

    def loss_rec(cfg, model, batch):
      total, metrics = loss_fn(cfg, model, batch)
      self.losses.append(float(metrics["loss"].detach()))
      return total, metrics

    def update_rec(cfg, grads, state, params, lr_scale=1.0, decay=None):
      if self.grad_faults is None:
        self.n_leaves = len(grads)
        self.grad_faults = [
            n for n, g in grads.items()
            if not (bool(torch.isfinite(g).all()) and bool((g != 0).any()))]
      name = self.leaf_name
      leaf = {"p": params[name].detach().clone(),
              "g": grads[name].clone(),
              "m": state["m"][name].clone(),
              "v": state["v"][name].clone(),
              "step": int(state["step"]) + 1, "lr_scale": lr_scale,
              "decay": True if decay is None else decay[name],
              "cfg": cfg, "name": name}
      out = update(cfg, grads, state, params, lr_scale, decay)
      leaf["after"] = params[name].detach().clone()
      leaf["clip_scale"] = out[2]["clip_scale"]
      self.leaf = leaf
      self.step_metrics.append({k: float(v) for k, v in out[2].items()})
      torch.cuda.synchronize()
      self.step_launches.append(self.ops.all_launches())
      return out

    def attn_rec(q, k, v, causal=True, **opts):
      if self.attn is None:
        self.attn = (q.detach().clone(), k.detach().clone(),
                     v.detach().clone(), causal, opts.get("window", 0))
      return attn(q, k, v, causal, **opts)

    def mask_rec(values, k, *args, **kwargs):
      if self.logits is None:
        self.logits = (values.detach().clone(), k, args, kwargs)
      return mask(values, k, *args, **kwargs)

    (self.steps.loss_from_batch, self.adamw.update, self.fa.flash_attention,
     self.moe.soft_topk_mask) = loss_rec, update_rec, attn_rec, mask_rec
    return self

  def __exit__(self, *exc):
    (self.steps.loss_from_batch, self.adamw.update, self.fa.flash_attention,
     self.moe.soft_topk_mask) = self._orig


def train_path(dev, fa, arch: str):
  """A train phase's run (``TRAIN_RUNS[arch]``): ``launch/train.py``'s
  ``main`` with every counter from 0, then its checks.  Returns (main's
  result, recorder, launches)."""
  from repro_torch.kernels import ops
  from repro_torch.launch import steps, train
  from repro_torch.models import moe
  from repro_torch.optim import adamw

  run = TRAIN_RUNS[arch]
  n_steps = run.get("steps", TRAIN_STEPS)
  ops.reset_all_launches()
  with TrainRecorder(ops, steps, adamw, fa, moe, run["leaf"]) as rec:
    res = train.main(run["args"])
  torch.cuda.synchronize()
  launches = ops.all_launches()
  cfg, state = res["cfg"], res["state"]
  check((cfg.num_layers, cfg.d_model, cfg.grad_accum, cfg.remat,
         cfg.dtype) == run["config"], f"train config {cfg}")
  check(state.step == n_steps == len(rec.step_launches),
        f"{state.step} steps taken, {len(rec.step_launches)} updates")
  per_step = train_launches_per_step(cfg)
  prev = dict.fromkeys(per_step, 0)
  for i, counts in enumerate(rec.step_launches):
    got = {k: counts[k] - prev[k] for k in per_step}
    check(got == per_step, f"train step {i}: launches {got}, counted from "
          f"the code {per_step}")
    prev = counts
  check(launches == {k: n_steps * n for k, n in per_step.items()},
        f"train launches {launches}")
  n_attn = attention_layers(cfg)
  say(f"train: {arch} launches {launches} in {n_steps} steps, "
      f"{per_step} a step as counted from the code ({cfg.grad_accum} "
      f"microbatches x {n_attn} attention layers of {cfg.num_layers} "
      f"{'/'.join(sorted(set(cfg.layer_kinds())))} x 2 passes under remat, "
      f"+ {cfg.grad_accum} soft-LTS sorts)")
  res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
  n_micro = n_steps * cfg.grad_accum
  check(len(rec.losses) == n_micro
        and all(math.isfinite(x) for x in rec.losses),
        f"train microbatch losses {rec.losses}")
  for i, m in enumerate(rec.step_metrics):
    check(all(math.isfinite(x) for x in m.values()),
          f"train step {i} metrics {m}")
  n_params = sum(1 for _ in state.model.parameters())
  check(rec.grad_faults == [] and rec.n_leaves == n_params,
        f"first step's gradients: {rec.n_leaves} leaves of {n_params}, "
        f"zero or not finite: {rec.grad_faults}")
  accum = cfg.grad_accum
  names = [n for n, _ in state.model.named_parameters()]
  among = [f"the {sum(f'.{kind}.' in n for n in names)} leaves of the "
           f"{kind} layers" for kind in ("rg", "mlstm", "slstm")
           if kind in cfg.layer_kinds()]
  if "slstm" in cfg.layer_kinds():
    among.append(f"the r of each of the {cfg.layer_kinds().count('slstm')} "
                 "slstm layers")
  if cfg.num_codebooks:
    among.append(f"the {cfg.num_codebooks} codebook heads")
  say(f"train: {arch} step losses " + ", ".join(
      f"{statistics.fmean(rec.losses[i * accum:(i + 1) * accum]):.4f}"
      for i in range(n_steps)) + "; grad norms " + ", ".join(
      f"{m['grad_norm']:.3f}" for m in rec.step_metrics) + " (all finite);"
      f" after step 1 all {n_params} parameter leaves had a finite, "
      "non-zero gradient" + (f", {', '.join(among)} among them" if among
                             else ""))
  return res, rec, launches


def adamw_card_vs_cpu(rec, dev) -> str:
  """The last step's AdamW update of the recorded leaf computed again by
  ``adamw.update_leaf`` on the card, with the step's scalars (clip scale,
  lr, bias corrections) as ``adamw.update`` computed them there (equal,
  after the cast, to what the trainer wrote), and on the CPU from the same
  inputs and scalars: the f32 results before the cast within one f32 ulp
  of each other.  (The scalars themselves come from ``pow`` on the card,
  which may round otherwise than the CPU's.)"""
  from repro_torch.optim import adamw

  leaf = rec.leaf
  cfg = leaf["cfg"]
  stepf = torch.tensor(leaf["step"], dtype=torch.float32, device=dev)
  scalars = (leaf["clip_scale"],
             cfg.lr * torch.as_tensor(leaf["lr_scale"], dtype=torch.float32,
                                      device=dev),
             1.0 - cfg.b1 ** stepf, 1.0 - cfg.b2 ** stepf)

  def on(device):
    return adamw.update_leaf(
        cfg, *(leaf[k].to(device) for k in ("p", "g", "m", "v")),
        *(x.to(device) for x in scalars), leaf["decay"])

  card = on(dev)
  check(torch.equal(card[0].to(leaf["after"].dtype), leaf["after"]),
        "the trainer's update of the expert leaf is not update_leaf's")
  card = [x.cpu() for x in card]
  cpu = on(torch.device("cpu"))
  parts = []
  for name, a, b in zip(("p", "m", "v"), card, cpu):
    ulp = torch.from_numpy(np.spacing(np.abs(b.numpy())))
    ratio = float(((a - b).abs() / ulp).max())
    check(ratio <= 1.0, f"AdamW {name}: card and CPU {ratio:.2f} ulp apart")
    parts.append(f"{name} {int((a != b).sum())} elements differ, at most "
                 f"{ratio:.2f} ulp")
  # Why update_leaf takes the square root in f64: the f32 one of the card
  # and of the CPU on the same v / bc2.
  vhat = ((leaf["v"] * cfg.b2) / scalars[3]).contiguous()
  f32_sqrt = int((torch.sqrt(vhat).cpu() != torch.sqrt(vhat.cpu())).sum())
  return (f"AdamW step {leaf['step']} of {leaf['name']} "
          f"{tuple(leaf['p'].shape)}, card vs CPU before the cast: "
          + "; ".join(parts) + " (limit 1 f32 ulp); an f32 torch.sqrt of "
          f"the leaf's b2 * v / bc2 differs between card and CPU in "
          f"{f32_sqrt} of {vhat.numel()} elements"
          "; update_leaf takes it in f64)")


def train_checks(rec, cfg, fa, dev, arch: str) -> tuple[list[str], dict]:
  """Each piece of a train path on its captured inputs: the attention
  forward kernel and ``flash_attention_bwd`` by their error models, the
  router's ``soft_topk_mask`` fwd+bwd against the ``scan`` backend on the
  card (a config with ``mla_moe`` layers and the soft top-k router must
  have called it, any other none), one AdamW update card against CPU.
  Returns the lines and the tensors the times reuse."""
  import repro_torch as rt

  if TRAIN_RUNS[arch]["attn"] is None:
    check(rec.attn is None and not attention_layers(cfg)
          and rec.logits is None,
          f"{arch}: an attention or router call recorded")
    return [f"train: {arch} called no attention kernel and no router (its "
            f"{cfg.num_layers} layers are "
            f"{'/'.join(sorted(set(cfg.layer_kinds())))})",
            "train: " + adamw_card_vs_cpu(rec, dev)], {"qkv": None}
  q, k, v, causal, window = rec.attn
  q_shape, v_shape = TRAIN_RUNS[arch]["attn"]
  check(tuple(q.shape) == q_shape and tuple(v.shape) == v_shape
        and window == TRAIN_RUNS[arch].get("window", 0),
        f"captured attention shapes {q.shape}, {v.shape}, window {window}")
  with torch.no_grad():
    out = fa.flash_attention(q, k, v, causal, window=window)
  fwd = attn_close(out, q, k, v, causal, fa, window)
  lines = [f"train: {arch} flash_attention forward on the captured layer "
           f"inputs q {tuple(q.shape)} k {tuple(k.shape)} v "
           f"{tuple(v.shape)} window {window}: {attn_text(fwd, fa)}"]
  gen = torch.Generator(device=dev).manual_seed(SEED)
  do = torch.randn(out.shape, generator=gen, device=dev,
                   dtype=torch.bfloat16)
  grads = fa.flash_attention_bwd(q, k, v, out, do, causal, window=window)
  for name, cmp in fa.compare_bwd_with_plain(grads, q, k, v, do, causal,
                                             window).items():
    text = attn_text(cmp, fa, f"{name} - {name} of the plain version's "
                     "autograd in f32")
    check(cmp["finite"] and cmp["tol_ratio"] <= 1.0
          and cmp["rel_frob"] <= fa.REL_FROB_LIMIT,
          f"flash_attention_bwd {name}: {text}")
    lines.append(f"train: flash_attention_bwd {name}: {text}")

  routed = "mla_moe" in cfg.layer_kinds() and cfg.router == "soft_topk"
  check(routed == (rec.logits is not None),
        f"{arch}: router {cfg.router} on layers {set(cfg.layer_kinds())}, "
        f"but {'no' if rec.logits is None else 'a'} router call recorded")
  if not routed:
    lines.append(f"train: {arch} called no router (no MoE layers)")
    lines.append("train: " + adamw_card_vs_cpu(rec, dev))
    return lines, {"qkv": (q, k, v), "out": out, "do": do,
                   "window": window}
  logits, kk, args, kwargs = rec.logits
  x = logits.reshape(-1, logits.shape[-1])
  cot = torch.randn(x.shape, generator=gen, device=dev)
  got = {}
  for impl in (None, "scan"):
    xi = x.clone().requires_grad_(True)
    mask = rt.soft_topk_mask(xi, kk, *args, impl=impl, **kwargs)
    got[impl] = (mask.detach(), torch.autograd.grad(mask, xi, cot)[0])
  e_val = close(got[None][0], got["scan"][0])
  e_grad = close(got[None][1], got["scan"][1])
  lines.append(f"train: router soft_topk_mask fwd+bwd on the captured "
               f"logits {tuple(x.shape)} k {kk}, cuda backend vs scan on "
               f"the card: values {e_val:.3e}, gradients {e_grad:.3e} "
               "(tol 1e-5 * (1 + max|scan|))")
  lines.append("train: " + adamw_card_vs_cpu(rec, dev))
  return lines, {"qkv": (q, k, v), "out": out, "do": do, "window": window}


def same_losses_text(first_losses, arch: str, other: str) -> str:
  """The first step's microbatch losses of ``arch`` against ``other``'s,
  from the same weights and batches: within 1e-6 relative (a remat
  changes no forward computation), and whether bit for bit."""
  got, want = first_losses[arch], first_losses[other]
  worst = max(abs(a - b) / abs(b) for a, b in zip(got, want))
  check(len(got) == len(want) and worst <= 1e-6,
        f"{arch}'s first step losses {got} vs {other}'s {want}")
  return (f"{arch}'s first step's {len(got)} microbatch losses "
          f"{', '.join(f'{x:.6f}' for x in got)} against {other}'s: worst "
          f"relative difference {worst:.3e} (tol 1e-6), "
          f"{'bit for bit' if got == want else 'not bit for bit'}")


def timed_steps(trainer, state, n: int) -> list[float]:
  """Seconds of ``n`` more train steps, timed as ``Trainer.run`` times
  them (a sync before, the loss read back after), with no recorder around
  the step's functions."""
  times = []
  for _ in range(n):
    batch = trainer.batch_at(state.step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, state.opt_state, metrics = trainer.train_step(
        state.model, state.opt_state, batch)
    loss = float(metrics["loss"])
    times.append(time.perf_counter() - t0)
    check(math.isfinite(loss), f"train step {state.step} loss {loss}")
    state.step += 1
  return times


def sliced_sqrt_rn(x, sqrt_rn, n: int) -> torch.Tensor:
  """``sqrt_rn`` over slices of ``n`` elements, so that each slice's f64
  copy could stay in L2 (a yardstick, not used by the trainer)."""
  out = torch.empty_like(x)
  for xs, os in zip(x.view(-1).split(n), out.view(-1).split(n)):
    os.copy_(sqrt_rn(xs))
  return out


def optimizer_times(trainer, state, name_limit, leaf: str) -> str:
  """``adamw.update`` over the trainer's whole state with random bf16
  gradients (CUDA-event medians), with each square root in turn:
  ``sqrt_rn`` (the trainer's), PyTorch's f32 ``torch.sqrt`` (not correctly
  rounded on the card) and the f64 round trip in three passes, then
  ``sqrt_rn`` again; and each square root alone on the leaf ``leaf``, also
  ``sqrt_rn`` in slices."""
  from repro_torch.models import transformer as T
  from repro_torch.optim import adamw

  dev = trainer.device
  params = dict(state.model.named_parameters())
  gen = torch.Generator(device=dev).manual_seed(SEED)
  grads = {n: torch.randn(p.shape, generator=gen, device=dev,
                          dtype=p.dtype) for n, p in params.items()}
  cfg, decay = trainer.opt_cfg, T.decay_mask(state.model)
  adam = state.opt_state["adam"]
  roots = {"sqrt_rn": adamw.sqrt_rn, "f32 torch.sqrt": torch.sqrt,
           "f64 round trip": lambda x: torch.sqrt(
               x.to(torch.float64)).to(torch.float32),
           "sqrt_rn in 2^22-element slices": lambda x: sliced_sqrt_rn(
               x, adamw.sqrt_rn, 1 << 22)}
  runs = []
  try:
    for name in ("sqrt_rn", "f32 torch.sqrt", "f64 round trip", "sqrt_rn"):
      adamw.sqrt_rn = roots[name]
      ms = median_ms(lambda: adamw.update(cfg, grads, adam, params, 1.0,
                                          decay), 3)
      runs.append(f"{name} {ms:.1f}")
  finally:
    adamw.sqrt_rn = roots["sqrt_rn"]
  del grads
  x = adam["v"][leaf].float().abs()
  alone = ", ".join(f"{name} {median_ms(lambda: fn(x), 10):.3f}"
                    for name, fn in roots.items())
  n = sum(p.numel() for p in params.values())
  dtype = str(next(iter(params.values())).dtype).removeprefix("torch.")
  return (f"times: adamw.update of all {len(params)} leaves ({n:,} "
          f"parameters, {dtype} gradients) by square root, in this order "
          f"(ms):"
          f" {'; '.join(runs)}; the square root alone on {leaf} "
          f"{tuple(x.shape)} f32 (ms): {alone} [{name_limit}]")


def train_times(res, rec, captured, fa, name_limit,
                arch: str) -> tuple[list[str], dict]:
  """Step ms (median of 3 steps after the recorded run, or of the run's
  ``timed_steps``; with 0, the recorded run's last step), positions/s,
  peak memory; the attention forward (with
  its plain version) and backward at the training shape beside SDPA's
  (none without attention layers); one more step under the profiler, or
  one microbatch's forward and backward for a run whose ``profile`` says
  so (with the sLSTM scan's share where there are slstm layers); the
  optimizer by square root.  Returns the lines and the attention kernel's
  row at the training shape (None without attention layers)."""
  from repro_torch.launch import steps, train

  lines = []
  run = TRAIN_RUNS[arch]
  trainer, state = res["trainer"], res["state"]
  dev = trainer.device
  cfg = res["cfg"]
  recorded = trainer.step_times
  n_rec = len(recorded)
  rec.leaf = {}     # the recorder's copies of the checked leaf
  torch.cuda.reset_peak_memory_stats(dev)
  n_timed = run.get("timed_steps", 3)
  if n_timed:
    times = timed_steps(trainer, state, n_timed)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    which = (f"median of {n_timed} steps after the recorded run, no "
             "recorder")
  else:   # the recorded run's last step is the timing
    times, peak = recorded[-1:], res["peak_gib"]
    which = f"the recorded run's step {n_rec}, with the recorder"
  med = statistics.median(times) * 1e3
  tokens = trainer.positions_per_step
  later = ""
  if n_rec > 1:
    rest = statistics.median(recorded[1:])
    later = (f" (median of steps 2-{n_rec} {rest * 1e3:.1f}, "
             f"{tokens / rest:.0f} positions/s)")
  lines.append(
      f"times: train {arch} {run['depth']}, batch "
      f"{TRAIN_BATCH} x {TRAIN_SEQ} {train.positions_trained(cfg)}, "
      f"grad_accum {cfg.grad_accum}, remat {cfg.remat}: step "
      f"{med:.1f} ms ({which}: "
      f"{', '.join(f'{t * 1e3:.1f}' for t in times)}), "
      f"{tokens / med * 1e3:.0f} positions/s; the recorded run's steps 1-"
      f"{n_rec}, with the recorder's syncs and clones: "
      f"{', '.join(f'{t * 1e3:.1f}' for t in recorded)}{later}; peak "
      f"memory {peak:.2f} GiB ({res['peak_gib']:.2f} in the recorded run) "
      f"[{name_limit}]")
  if run.get("timed") == "steps":
    return lines, None
  row = None
  if captured["qkv"] is not None:
    row, line = train_attn_times(captured, fa, name_limit, arch)
    lines.append(line)

  batch = trainer.batch_at(state.step)
  slstm = "slstm" in cfg.layer_kinds()
  ranges = TRAIN_RANGES + (SLSTM_RANGES if slstm else ())
  if run.get("profile") == "microbatch":
    mb = TRAIN_BATCH // cfg.grad_accum
    micro = {k: t[:mb] for k, t in batch.items()}
    params = [p for p in state.model.parameters()]
    what = (f"microbatch ({mb} x {TRAIN_SEQ}: the loss and its gradients, "
            f"1/{cfg.grad_accum} of a step without the optimizer)")

    def fn():
      total, _ = steps.loss_from_batch(cfg, state.model, micro)
      torch.autograd.grad(total, params)
  else:
    what = "train step"

    def fn():
      trainer.train_step(state.model, state.opt_state, batch)

  wall, busy, top, spans = profile(fn, ranges)
  kernels = "; ".join(f"{key[:60]} {ms:.1f}" for key, ms, _ in top[:5])
  groups = dict.fromkeys(KERNEL_GROUPS, 0.0)
  for key, ms, _ in top:
    groups[next((g for g, pats in KERNEL_GROUPS.items()
                 if any(p in key for p in pats)), "other")] += ms
  group_text = ", ".join(f"{g} {ms:.1f}" for g, ms in groups.items())
  launches = sum(n for _, _, n in top)
  busy_text = (NOT_PROFILED
               if busy is None else
               f"{busy:.1f} ms ({100 * (1 - busy / wall):.0f}% idle) in "
               f"{launches} kernel launches; by kind (ms): {group_text}")
  span_text = "; ".join(f"{name} host {cpu:.1f} ms, device span "
                        f"{dev_ms:.1f} ms" for name, (cpu, dev_ms, _, _) in
                        spans.items() if name in TRAIN_RANGES)
  share = ""
  if slstm:
    share = (f"; the {cfg.layer_kinds().count('slstm')} slstm layers' "
             "scans (forward, its recompute under remat, and backward) "
             + range_share_text(wall, busy, top, spans, SLSTM_RANGES))
  lines.append(f"times: profile of one {arch} {what}: wall {wall:.1f} "
               f"ms, device busy {busy_text}; ranges (summed over the "
               f"microbatches): {span_text}; most device time (ms): "
               f"{kernels}{share} [{name_limit}]")
  lines.append(optimizer_times(trainer, state, name_limit, run["leaf"]))
  return lines, row


def train_attn_times(captured, fa, name_limit, arch: str):
  """The attention forward (with its plain version) and backward at the
  training shape on the captured call, beside SDPA's forward and forward +
  backward.  Returns (row, line)."""
  q, k, v = captured["qkv"]
  out, do, window = captured["out"], captured["do"], captured["window"]
  fwd_ms = median_ms(lambda: fa.flash_attention(q, k, v, True,
                                                window=window), 20)
  bound_ms, bound_by = attn_bound(q, k, v, True, window)
  fwd_dev = kernel_device_ms(lambda: fa.flash_attention(q, k, v, True,
                                                        window=window),
                             "flash_kernel", bound_ms=bound_ms)
  plain_ms = median_ms(lambda: fa.flash_attention_plain(q, k, v,
                                                        window=window), 3)
  bwd = lambda: fa.flash_attention_bwd(  # noqa: E731
      q, k, v, out, do, True, window=window)
  bwd_ms = median_ms(bwd, 10)
  bwd_dev = kernel_device_ms(bwd, "", calls=5)
  qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                for t in (q, k, v))
  dot = do.transpose(1, 2)
  gqa = q.shape[2] != k.shape[2]
  mask = band_mask(q, k, window)

  def sdpa(*xs):
    return torch.nn.functional.scaled_dot_product_attention(
        *xs, attn_mask=mask, is_causal=not window, enable_gqa=gqa)

  def sdpa_fwd():
    with torch.no_grad():
      sdpa(qt, kt, vt)

  def sdpa_fwd_bwd():
    torch.autograd.grad(sdpa(qt, kt, vt), (qt, kt, vt), dot)

  lib_fwd = median_ms(sdpa_fwd, 20)
  lib_fb = median_ms(sdpa_fwd_bwd, 10)
  lib_fb_dev = kernel_device_ms(sdpa_fwd_bwd, "", calls=5)
  row = {"ms": fwd_ms, "device_ms": fwd_dev, "plain_ms": plain_ms,
         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_fwd,
         "shape": list(q.shape), "width": [q.shape[-1], v.shape[-1]],
         "window": window, "bwd_ms": bwd_ms, "library_fwd_bwd_ms": lib_fb}
  return row, (
      f"times: train {arch} attention q {tuple(q.shape)} k "
      f"{tuple(k.shape)} v {tuple(v.shape)} "
      + (f"window {window} (SDPA: a boolean band mask)" if window
         else "causal") + ": kernel forward "
      f"{fwd_ms:.4f} ms (device {ms_text(fwd_dev)}, profiler), plain "
      f"{plain_ms:.3f} ms, bound {bound_ms:.5f} ms ({bound_by}); "
      f"flash_attention_bwd {bwd_ms:.3f} ms (device {ms_text(bwd_dev)}, "
      f"all its kernels); scaled_dot_product_attention forward "
      f"{lib_fwd:.4f} ms, forward + backward {lib_fb:.4f} ms (device "
      f"{ms_text(lib_fb_dev)}), so its backward about "
      f"{lib_fb - lib_fwd:.4f} ms [{name_limit}]")


# ---------------------------------------------------------------------------
# Mesh phase: the sharded main path on a one-rank NCCL group.
# ---------------------------------------------------------------------------

# The card is one H100, so every sharded run is at world size 1: a real
# NCCL group of one rank, meshes (1, 1) over (data, model) and (1, 1, 1)
# over (pod, data, model).  That proves the code path (NCCL, DTensor
# dispatch, the kernels fed from local blocks), not scaling; many ranks are
# traced by the dry run.  llama3.2-1b trains whole (FSDP on, so that every
# rule path runs) for MESH_TRAIN_STEPS steps at the train phase's shapes
# and seed, deepseek-v2-lite-16b serves whole (8 x 512 and MESH_SERVE_STEPS
# decode steps); each against the same run without a mesh on the card, bit
# for bit.
MESH_TRAIN_STEPS = 2
MESH_SERVE_STEPS = 4
# The dry run on the card's host: both archs at all four shapes on the
# 16 x 16 mesh, and one 2 x 16 x 16 cell, in CPU processes started after the
# CPU workers of phase 3 (they share the host, not the card).
DRYRUN_ARCHS = (DENSE_ARCH, ARCH)
DRYRUN_MULTI = (DENSE_ARCH, "decode_32k")


def start_dryrun(out_dir: str) -> list:
  """The dry run's CLI in 3 CPU processes (no card: CUDA hidden), one
  thread each, pinned to the host's last two cores where it has 4 or
  more (deepseek's on the last, both llama ones on the one before), so
  that the timed phases beside them keep the other cores."""
  import os
  env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
             PYTHONPATH=str(ROOT / "src"))
  cores = sorted(os.sched_getaffinity(0))
  cmds = [["--arch", arch, "--mesh", "single"] for arch in DRYRUN_ARCHS]
  cmds.append(["--arch", DRYRUN_MULTI[0], "--shape", DRYRUN_MULTI[1],
               "--mesh", "multi"])
  procs = []
  for cmd in cmds:
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--out", out_dir,
         "--force", *cmd], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    if len(cores) >= 4:
      os.sched_setaffinity(proc.pid,
                           {cores[-1] if cmd[1] == ARCH else cores[-2]})
    procs.append((cmd, time.perf_counter(), proc))
  return procs


def dryrun_lines(procs, out_dir: str) -> list[str]:
  """Wait for the dry run's processes; each cell's dominant term, bound
  and per-device GiB.  Fails on an error cell or a nonzero exit."""
  lines = []
  for cmd, t0, proc in procs:
    out, _ = proc.communicate(timeout=900)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"dry run {cmd} exit {proc.returncode}:\n"
          + out[-3000:])
    lines.append(f"dryrun: {' '.join(cmd)}: exit 0, ended within {wall:.1f}"
                 " s of its start (read after the mesh phase; on the host's "
                 "CPU, no card)")
  for path in sorted(Path(out_dir).glob("*.json")):
    if path.name.endswith(".ops.json"):
      continue
    rec = json.loads(path.read_text())
    cell = f"{rec['arch']} {rec['shape']} {rec['mesh']}"
    if rec["status"] == "skipped":
      lines.append(f"dryrun: {cell}: skipped ({rec['reason']})")
      continue
    check(rec["status"] == "ok", f"dry run {cell}: {rec.get('error')}")
    roof, cost, mem = rec["roofline"], rec["cost"], rec["memory"]
    lines.append(
        f"dryrun: {cell}: {rec['devices']} ranks, trace {rec['trace_s']} s; "
        f"dominant {roof['dominant']}, bound {roof['bound_s'] * 1e3:.3f} ms "
        f"(compute {roof['compute_s'] * 1e3:.3f}, memory "
        f"{roof['memory_s'] * 1e3:.3f}, collective "
        f"{roof['collective_s'] * 1e3:.3f} ms); useful FLOPs ratio "
        f"{roof['useful_flops_ratio']:.3f}; {mem['peak_estimate_bytes'] / 2**30:.2f}"
        f" GiB a device ({mem['argument_bytes'] / 2**30:.2f} arguments + "
        f"{mem['traced_peak_bytes'] / 2**30:.2f} traced peak); collectives "
        + json.dumps(cost["collectives_by_type"]))
  return lines


def _full(t: torch.Tensor) -> torch.Tensor:
  from torch.distributed.tensor import DTensor
  return t.full_tensor() if isinstance(t, DTensor) else t


def mesh_train(dev, mesh2, kops, name_limit) -> tuple[list[str], dict,
                                                     dict]:
  """llama3.2-1b's trainer for MESH_TRAIN_STEPS steps without a mesh, then
  with its parameters, optimizer state and batches distributed on the
  (1, 1) mesh under the rules; losses and updated parameters bit for bit,
  launches as counted from the code; then the sharded parameters through
  a checkpoint, restored onto the mesh with other placements.  Returns
  (lines, the sharded run's launches, timings)."""
  import dataclasses
  import shutil
  from torch.distributed.tensor import Replicate
  from repro_torch.checkpoint import checkpointer as ckpt
  from repro_torch.configs.base import get_config
  from repro_torch.launch import mesh as M
  from repro_torch.launch import steps as ST
  from repro_torch.launch import train
  from repro_torch.optim import adamw
  from repro_torch.sharding import specs as SP

  cfg = dataclasses.replace(get_config(DENSE_ARCH), fsdp=True,
                            loss_trim_fraction=TRIM_FRACTION)
  opt_cfg = adamw.AdamWConfig()
  trainer = train.Trainer(cfg, opt_cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                          corrupt_fraction=0.1, total_steps=MESH_TRAIN_STEPS,
                          seed=SEED, device="cuda")
  rules = SP.ShardingRules(mesh2, data_axes=M.data_axes_of(mesh2),
                           fsdp=True)
  per_step = train_launches_per_step(cfg)

  def run(sharded: bool):
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    state = trainer.init_or_restore()
    model, opt = state.model, state.opt_state
    if sharded:
      SP.distribute_model(model, mesh2, SP.param_specs_tree(rules, model))
      opt = None
      gc.collect()
      opt = ST.init_opt_state(cfg, opt_cfg, dict(model.named_parameters()))
    losses, times = [], []
    kops.reset_all_launches()
    for step in range(MESH_TRAIN_STEPS):
      batch = trainer.batch_at(step)
      if sharded:
        batch = SP.distribute_tree(batch, mesh2,
                                   SP.batch_specs_tree(rules, batch))
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      with SP.use_rules(rules if sharded else None):
        _, opt, metrics = trainer.train_step(model, opt, batch)
      losses.append(_full(metrics["loss"]).item())
      torch.cuda.synchronize()
      times.append(time.perf_counter() - t0)
    launches = kops.all_launches()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    return model, opt, losses, times, launches, peak

  model, opt, ref_losses, ref_times, ref_launches, ref_peak = run(False)
  ref = {n: p.detach().clone() for n, p in model.named_parameters()}
  del model, opt
  model, opt, losses, times, launches, peak = run(True)
  want = {k: MESH_TRAIN_STEPS * n for k, n in per_step.items()}
  check(launches == ref_launches == {**launches, **want},
        f"mesh train launches {launches}, unsharded {ref_launches}, counted "
        f"from the code {want}")
  check(losses == ref_losses, f"mesh train losses {losses} vs {ref_losses}")
  differ = [n for n, p in model.named_parameters()
            if not torch.equal(p.full_tensor(), ref[n])]
  check(not differ, f"mesh train: {len(differ)} parameters differ from the "
        f"unsharded run's: {differ[:5]}")
  lines = [
      f"mesh: {DENSE_ARCH} train on the (1, 1) mesh (FSDP rules), "
      f"{MESH_TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ}: losses "
      f"{losses} bit for bit the unsharded run's; all "
      f"{len(ref)} updated parameters bit for bit; launches {launches} "
      f"({per_step} a step, as without a mesh)",
      f"mesh: {DENSE_ARCH} train step s: sharded "
      f"{[round(t, 3) for t in times]}, unsharded "
      f"{[round(t, 3) for t in ref_times]} (host clock, the first step "
      f"each includes warm-up); peak {peak:.2f} GiB sharded, {ref_peak:.2f}"
      f" GiB unsharded [{name_limit}]"]

  directory = tempfile.mkdtemp(prefix="mesh_ckpt_")
  try:
    t0 = time.perf_counter()
    ckpt.save(directory, MESH_TRAIN_STEPS,
              {"params": dict(model.named_parameters())})
    saved = time.perf_counter() - t0
    places = {"params": {n: (Replicate(), Replicate()) for n in ref}}
    tree, _ = ckpt.restore(directory, {"params": ref}, mesh=mesh2,
                           placements=places)
    moved = sum(t.placements != model.get_parameter(n).placements
                for n, t in tree["params"].items())
    bad = [n for n, t in tree["params"].items()
           if t.placements != (Replicate(), Replicate())
           or not torch.equal(t.full_tensor(), ref[n])]
    check(not bad and moved > 0, f"mesh checkpoint: {bad[:5]} differ, "
          f"{moved} leaves changed placements")
  finally:
    shutil.rmtree(directory, ignore_errors=True)
  lines.append(
      f"mesh: {DENSE_ARCH} checkpoint of the sharded parameters (full "
      f"tensors, {saved:.1f} s to write) restored onto the (1, 1) mesh "
      f"replicated ({moved} of {len(ref)} leaves change placements), bit "
      f"for bit")
  del model, opt, ref, tree
  return lines, launches, {"step_s": times, "plain_step_s": ref_times,
                           "peak_gib": peak, "plain_peak_gib": ref_peak}


def mesh_serve(dev, mesh2, kops, name_limit) -> tuple[list[str], dict]:
  """deepseek-v2-lite-16b whole: a prefill of SERVE_BATCH x SERVE_PROMPT
  and MESH_SERVE_STEPS decode steps without a mesh, then the same weights
  distributed on the (1, 1) mesh and the same tokens fed; logits bit for
  bit, 27 attention and 27 gate launches a prefill, 27 gates a step."""
  from repro_torch.configs.base import get_config
  from repro_torch.launch import mesh as M
  from repro_torch.launch import steps as ST
  from repro_torch.models import transformer as T
  from repro_torch.sharding import specs as SP

  gc.collect()
  torch.cuda.empty_cache()
  cfg = get_config(ARCH)
  model = T.init_params(cfg, SEED, dev)
  g = torch.Generator().manual_seed(SEED)
  prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                          generator=g).to(dev)
  prefill = ST.make_prefill_step(cfg, SERVE_PROMPT + MESH_SERVE_STEPS)
  decode = ST.make_decode_step(cfg)
  rules = SP.ShardingRules(mesh2, data_axes=M.data_axes_of(mesh2),
                           fsdp=cfg.fsdp,
                           seq_shard_activations=cfg.seq_shard_activations)

  def run(sharded: bool, tokens=None):
    batch = {"tokens": prompts}
    if sharded:
      batch = {"tokens": SP.distribute(prompts, mesh2,
                                       SP.batch_spec(rules, prompts.shape))}
    torch.cuda.reset_peak_memory_stats(dev)
    kops.reset_all_launches()
    logits, times, counts = [], [], []
    with torch.no_grad(), SP.use_rules(rules if sharded else None):
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      out, caches = prefill(model, batch)
      torch.cuda.synchronize()
      times.append(time.perf_counter() - t0)
      counts.append(kops.all_launches())
      logits.append(_full(out))
      toks = tokens or []
      for i in range(MESH_SERVE_STEPS):
        if not sharded:
          toks.append(torch.argmax(logits[-1], dim=-1))
        tok = toks[i]
        if sharded:
          tok = SP.distribute(tok, mesh2, SP.batch_spec(rules, tok.shape))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, caches = decode(model, caches, tok, SERVE_PROMPT + i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        logits.append(_full(out))
    del caches
    return (logits, toks, times, counts, kops.all_launches(),
            torch.cuda.max_memory_allocated(dev) / 2**30)

  ref_logits, toks, ref_times, _, _, ref_peak = run(False)
  SP.distribute_model(model, mesh2, SP.param_specs_tree(rules, model))
  gc.collect()
  logits, _, times, counts, launches, peak = run(True, toks)
  n = cfg.num_layers
  check(counts[0] == {**counts[0], "flash_attention": n,
                      "soft_topk_gates": n, "flash_attention_simt": 0,
                      "decode_attention": 0},
        f"mesh prefill launches {counts[0]}")
  check(launches == {**launches, "flash_attention": n,
                     "soft_topk_gates": n * (1 + MESH_SERVE_STEPS),
                     "flash_attention_simt": 0, "decode_attention": 0},
        f"mesh serve launches {launches}")
  differ = [i for i, (a, b) in enumerate(zip(logits, ref_logits))
            if not torch.equal(a, b)]
  check(not differ, f"mesh serve: logits of steps {differ} differ from the "
        "unsharded run's by " + ", ".join(
            f"{float((logits[i] - ref_logits[i]).abs().max()):.3e}"
            for i in differ))
  del model
  lines = [
      f"mesh: {ARCH} served on the (1, 1) mesh (rules with FSDP and "
      f"sequence-sharded activations): prefill {SERVE_BATCH} x "
      f"{SERVE_PROMPT} and {MESH_SERVE_STEPS} decode steps, logits bit for "
      f"bit the unsharded run's; launches {launches} ({n} attention and "
      f"{n} gates a prefill, {n} gates a step)",
      f"mesh: {ARCH} serve s: sharded prefill {times[0]:.3f}, decode "
      f"{[round(t, 4) for t in times[1:]]}; unsharded prefill "
      f"{ref_times[0]:.3f}, decode {[round(t, 4) for t in ref_times[1:]]} "
      f"(host clock, first calls warm-up); peak {peak:.2f} GiB sharded, "
      f"{ref_peak:.2f} GiB unsharded [{name_limit}]"]
  return lines, launches


def mesh_psum(dev, mesh3) -> str:
  """``pod_psum_int8`` through NCCL on the (1, 1, 1) mesh: each device's
  int8 round trip of its own block, summed over one pod, bit for bit."""
  from repro_torch.optim import compression
  from repro_torch.sharding import specs as SP

  g = torch.Generator(device=dev).manual_seed(SEED)
  x = torch.randn((4096, 4096), generator=g, device=dev) * 3.0
  spec = ("pod", "data")
  out = compression.pod_psum_int8(SP.distribute(x, mesh3, spec), mesh3,
                                  spec)
  want = compression._dequant(*compression._quant_int8(x))
  check(out.placements == SP.placements(mesh3, spec)
        and torch.equal(out.to_local(), want),
        "pod_psum_int8 differs from the int8 round trip on one rank")
  return ("mesh: pod_psum_int8 over the (1, 1, 1) mesh's pod axis through "
          f"NCCL, (4096, 4096) f32 spec {spec}: bit for bit the int8 round "
          "trip (dequantized f32 on the wire, summed over 1 pod)")


def mesh_phase(dev, kops, name_limit) -> tuple[list[str], dict]:
  """The mesh phase: a one-rank NCCL group, the (1, 1) and (1, 1, 1)
  meshes, the sharded trainer and server against the unsharded ones, the
  int8 pod all-reduce, the checkpoint across placements; the group is
  destroyed at the end.  Returns (lines, launches by run)."""
  import torch.distributed as dist
  from repro_torch.launch import mesh as M

  t0 = time.perf_counter()
  dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                          world_size=1)
  try:
    mesh2 = M.make_debug_mesh((1, 1), ("data", "model"))
    mesh3 = M.make_debug_mesh((1, 1, 1), ("pod", "data", "model"))
    lines = [mesh_psum(dev, mesh3)]
    train_lines, train_counts, _ = mesh_train(dev, mesh2, kops, name_limit)
    serve_lines, serve_counts = mesh_serve(dev, mesh2, kops, name_limit)
  finally:
    dist.destroy_process_group()
  lines += train_lines + serve_lines
  lines.append(f"mesh: phase {time.perf_counter() - t0:.1f} s; NCCL group "
               f"destroyed: {not dist.is_initialized()}")
  return lines, {f"{DENSE_ARCH} train": train_counts,
                 f"{ARCH} serve": serve_counts}


# ---------------------------------------------------------------------------
# The CUDA-core attention kernel (f32, any width), every smoke config on the
# card, and the example programs.
# ---------------------------------------------------------------------------

SIMT = "flash_attention_simt"
F32, BF16 = torch.float32, torch.bfloat16
# Phase 3's cases of the CUDA-core kernel: (what, B, Sq, Skv, H, Hkv, D, Dv,
# dtype, causal, window, softcap, q_offset).  The smoke configs' attention
# (2 x 48 positions, G 2, causal and under their window of 32), MLA's
# smoke widths (24, 16), the MoE example's (32, 32) at G 2, the robust LM
# example's --full layers (64, 64) at G 3, bf16 at (96, 96), which the
# tensor-core kernel is not built for (G 4, a ragged S, causal and not),
# and at one f32 shape the options: a soft-cap of 30 (q x HOT_Q), queries
# that continue a cache, a window without ``causal``.  Then the edges of the
# kernel's tiles (64 keys; f32 row blocks of 16, 32 or 64 rows, bf16 of 16,
# 32, 64 or 128 rows whose 4 warps split the keys at 16 and 32): Sq * G no
# multiple of the row block over Skv != Sq, G 3, 6 and 200, D = 8, (8, 256)
# and (256, 256) in f32 (one stage), bf16 at (40, 40) and (24, 16), which
# are multiples of 8 but not of 16, and at (96, 64), the window, soft-cap and
# query offset on the bf16 (mma) path, and the two prefill shapes of phase 5
# (llama3.2-1b under --set dtype=float32, and bf16 at (96, 96) with its
# heads: the 128-row bf16 block).
SIMT_ATTN_CASES = (
    ("smoke configs", 2, 48, 48, 4, 2, 16, 16, F32, True, 0, 0.0, 0),
    ("smoke configs, window", 2, 48, 48, 4, 2, 16, 16, F32, True, 32, 0.0,
     0),
    ("MLA smoke widths", 2, 48, 48, 4, 4, 24, 16, F32, True, 0, 0.0, 0),
    ("MoE example", 8, 64, 64, 4, 2, 32, 32, F32, True, 0, 0.0, 0),
    ("robust LM --full", 8, 128, 128, 12, 4, 64, 64, F32, True, 0, 0.0, 0),
    ("bf16 unbuilt width", 1, 333, 333, 4, 1, 96, 96, BF16, True, 0, 0.0, 0),
    ("bf16 unbuilt width", 1, 333, 333, 4, 1, 96, 96, BF16, False, 0, 0.0,
     0),
    ("soft-cap", 2, 128, 128, 12, 4, 64, 64, F32, True, 0, 30.0, 0),
    ("query offset", 2, 64, 192, 12, 4, 64, 64, F32, True, 0, 0.0, 128),
    ("window without causal", 2, 128, 128, 12, 4, 64, 64, F32, False, 40,
     0.0, 0),
    ("ragged rows, Skv > Sq", 2, 100, 164, 8, 2, 64, 64, F32, True, 0, 0.0,
     64),
    ("G 3, not causal", 2, 77, 90, 6, 2, 32, 32, F32, False, 0, 0.0, 0),
    ("G 6", 1, 90, 120, 12, 2, 64, 64, F32, True, 0, 0.0, 30),
    ("G 200, (8, 256)", 1, 50, 50, 200, 1, 8, 256, F32, True, 0, 0.0, 0),
    ("D 8", 2, 70, 70, 4, 4, 8, 8, F32, True, 0, 0.0, 0),
    ("(256, 256)", 1, 200, 200, 8, 4, 256, 256, F32, True, 0, 0.0, 0),
    ("bf16 (40, 40)", 1, 100, 100, 4, 1, 40, 40, BF16, True, 0, 0.0, 0),
    ("bf16 MLA smoke widths", 2, 48, 48, 4, 4, 24, 16, BF16, True, 0, 0.0,
     0),
    ("bf16 (96, 64)", 1, 120, 120, 4, 2, 96, 64, BF16, True, 0, 0.0, 0),
    ("bf16 window", 1, 333, 400, 4, 1, 96, 96, BF16, True, 100, 0.0, 60),
    ("bf16 soft-cap", 1, 100, 160, 8, 2, 40, 40, BF16, True, 0, 30.0, 60),
    ("bf16 query offset", 2, 64, 192, 12, 4, 96, 96, BF16, True, 0, 0.0,
     128),
    ("llama3.2-1b f32 prefill", 8, 512, 512, 32, 8, 64, 64, F32, True, 0,
     0.0, 0),
    ("bf16 (96, 96) at llama's heads", 8, 512, 512, 32, 8, 96, 96, BF16,
     True, 0, 0.0, 0),
)
# The backward's f32 case (B, S, H, Hkv, D): the robust LM example's
# layers at 2 sequences.
SIMT_BWD_CASE = (2, 128, 12, 4, 64)
# Phase 5's shapes: the paths' own (the smoke configs, MLA's smoke widths,
# the examples), bf16 (96, 96) over one kv head, and the two prefills above.
SIMT_TIME_WHATS = ("smoke configs", "smoke configs, window",
                   "MLA smoke widths", "MoE example", "robust LM --full",
                   "bf16 unbuilt width", "llama3.2-1b f32 prefill",
                   "bf16 (96, 96) at llama's heads")
SIMT_TIME_CASES = tuple(c for c in SIMT_ATTN_CASES
                        if c[0] in SIMT_TIME_WHATS and c[9])


def simt_inputs(dev, b, sq, skv, h, hkv, d, dv, dtype, softcap=0.0,
                seed=0):
  gen = torch.Generator(device=dev).manual_seed(seed)
  q = torch.randn((b, sq, h, d), generator=gen, device=dev, dtype=dtype)
  q = q * HOT_Q if softcap else q
  k = torch.randn((b, skv, hkv, d), generator=gen, device=dev, dtype=dtype)
  v = torch.randn((b, skv, hkv, dv), generator=gen, device=dev, dtype=dtype)
  return q, k, v


def simt_text(cmp: dict, diff: str = "kernel - plain in f32") -> str:
  model = ("f32 model" if cmp["rel_frob_limit"] < 2.0**-10
           else "bf16 model, tol = 2**-7 * (|ref| + A)")
  return (f"max |{diff}| {cmp['max_abs_err']:.3e}, worst |err| / tol "
          f"{cmp['tol_ratio']:.4f} (limit 1; {model}), relative Frobenius "
          f"error {cmp['rel_frob']:.3e} (limit {cmp['rel_frob_limit']:.3e}),"
          f" median |ref| {cmp['median_ref']:.3e}")


def launch_delta(kops, before: dict) -> dict:
  return {k: v - before.get(k, 0) for k, v in kops.all_launches().items()
          if v != before.get(k, 0)}


def simt_kernel_checks(dev, fa, kops, max_err) -> None:
  """Phase 3: the CUDA-core kernel against the plain version on the card
  (``SIMT_ATTN_CASES``, by the error model of the output's dtype), its
  backward at one f32 shape by the backward's model, and the route: bf16
  at each built width launches the tensor-core kernel alone, f32 at (64,
  64) the CUDA-core kernel alone, (264, 264) and (20, 20) raise with no
  launch of either."""
  for (what, b, sq, skv, h, hkv, d, dv, dtype, causal, window, softcap,
       q_offset) in SIMT_ATTN_CASES:
    q, k, v = simt_inputs(dev, b, sq, skv, h, hkv, d, dv, dtype, softcap,
                          seed=sq + skv + d + window + q_offset)
    opts = dict(window=window, softcap=softcap, q_offset=q_offset)
    before = kops.all_launches()
    out = fa.flash_attention(q, k, v, causal, **opts)
    torch.cuda.synchronize()
    delta = launch_delta(kops, before)
    check(delta == {SIMT: 1}, f"{SIMT} {what}: launches {delta}")
    check(out.dtype == dtype, f"{SIMT} {what}: output {out.dtype}")
    cmp = fa.compare_with_plain(out, q, k, v, causal or window > 0, **opts)
    check(cmp["finite"] and cmp["tol_ratio"] <= 1.0
          and cmp["rel_frob"] <= cmp["rel_frob_limit"],
          f"{SIMT} {what}: {simt_text(cmp)}")
    max_err[SIMT] = max(max_err.get(SIMT, 0.0), cmp["max_abs_err"])
    say(f"kernels: {SIMT} {what}: q ({b}, {sq}, {h}, {d}) kv ({skv}, {hkv}) "
        f"Dv {dv} (G {h // hkv}) {str(dtype)[6:]} causal {causal} window "
        f"{window} softcap {softcap} q_offset {q_offset}, one launch: "
        f"{simt_text(cmp)}")
  b, s, h, hkv, d = SIMT_BWD_CASE
  xs = [t.requires_grad_(True)
        for t in simt_inputs(dev, b, s, s, h, hkv, d, d, F32, seed=7)]
  out = fa.flash_attention(*xs, True)
  do = torch.randn(out.shape, generator=torch.Generator(
      device=dev).manual_seed(8), device=dev)
  grads = torch.autograd.grad(out, xs, do)
  texts = []
  for name, c in fa.compare_bwd_with_plain(
      grads, *(t.detach() for t in xs), do, True).items():
    check(c["finite"] and c["tol_ratio"] <= 1.0
          and c["rel_frob"] <= c["rel_frob_limit"],
          f"{SIMT} backward {name}: {c}")
    texts.append(f"{name} max |err| {c['max_abs_err']:.3e}, |err| / tol "
                 f"{c['tol_ratio']:.5f}, relative Frobenius "
                 f"{c['rel_frob']:.3e} (limit {c['rel_frob_limit']:.3e})")
  say(f"kernels: {SIMT} f32 q ({b}, {s}, {h}, {d}) G {h // hkv} under "
      "autograd, flash_attention_bwd against the plain version's autograd "
      "by the backward's f32 error model: " + "; ".join(texts))
  routed = []
  for d, dv in fa.KERNEL_WIDTHS:
    hkv = 4 if d != dv else 2
    q, k, v = simt_inputs(dev, 1, 64, 64, 4, hkv, d, dv, BF16, seed=d)
    before = kops.all_launches()
    fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    delta = launch_delta(kops, before)
    check(delta == {"flash_attention": 1},
          f"bf16 ({d}, {dv}): launches {delta}, not the tensor-core kernel "
          "alone")
    routed.append(f"bf16 ({d}, {dv}) -> flash_attention")
  q, k, v = simt_inputs(dev, 1, 64, 64, 4, 2, 64, 64, F32, seed=64)
  before = kops.all_launches()
  fa.flash_attention(q, k, v)
  torch.cuda.synchronize()
  delta = launch_delta(kops, before)
  check(delta == {SIMT: 1}, f"f32 (64, 64): launches {delta}")
  routed.append(f"f32 (64, 64) -> {SIMT}")
  for width in (264, 20):
    for dtype in (F32, BF16):
      x = torch.zeros((1, 8, 4, width), dtype=dtype, device=dev)
      before = kops.all_launches()
      try:
        fa.flash_attention(x, x, x)
      except ValueError:
        refused = True
      else:
        refused = False
      check(refused and not launch_delta(kops, before),
            f"{str(dtype)[6:]} ({width}, {width}) did not raise before a "
            "launch")
      routed.append(f"{str(dtype)[6:]} ({width}, {width}) raises ValueError"
                    " with no launch")
  say("kernels: attention route on the card: " + "; ".join(routed))


def simt_bound(q, k, v, causal: bool, window: int = 0, softcap: float = 0.0,
               q_offset: int = 0) -> tuple[float, str]:
  """Least time for the CUDA-core kernel: bytes (q, k, v read once, out
  written once, in their dtype) against its operations: 2 (D + Dv) FLOPs a
  computed (query, key) pair for the products, at the f32 rate outside the
  tensor cores for f32 (FFMA) and at the bf16 tensor-core rate for bf16
  (mma.sync), as ``attn_bound`` counts them, plus 5 f32 operations a score
  for the softmax (2 more under a soft-cap) at the f32 rate."""
  from repro_torch.kernels.flash_attention import attention_pairs
  b, sq, h, d = q.shape
  skv, dv = k.shape[1], v.shape[-1]
  pairs = b * h * attention_pairs(sq, skv, causal, window, q_offset)
  n_bytes = (q.numel() + k.numel() + v.numel() + b * sq * h * dv) * (
      q.element_size())
  products = pairs * 2 * (d + dv)
  scores = pairs * (5 + (2 if softcap > 0 else 0))
  product_rate = BF16_OPS_PER_S if q.dtype == BF16 else F32_OPS_PER_S
  bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
  ops_ms = (products / product_rate + scores / F32_OPS_PER_S) * 1e3
  return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def simt_build_info() -> dict:
  """Registers and spill bytes of each instantiation of the CUDA-core
  kernel, from the build's ptxas log: ("ffma", M, NG) or ("mma", NT, MT)
  -> (registers, spill store bytes, spill load bytes)."""
  from repro_torch.kernels import _build
  info, key, spills = {}, None, (0, 0)
  for line in _build.BUILD_LOG.get(SIMT, "").splitlines():
    m = re.search(r"attention_simt_(ffma|mma)ILi(\d+)ELi(\d+)E", line)
    if m and "Compiling entry function" in line:
      key = (m.group(1), int(m.group(2)), int(m.group(3)))
      continue
    m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                  line)
    if m and key:
      spills = (int(m.group(1)), int(m.group(2)))
    m = re.search(r"Used (\d+) registers", line)
    if m and key:
      info[key] = (int(m.group(1)), *spills)
      key, spills = None, (0, 0)
  return info


def simt_plan_text(fa, q, v, build_info) -> tuple[dict, str]:
  """The launch plan of the CUDA-core kernel at q's and v's shapes
  (``simt_plan``) with its instantiation's registers and spills."""
  b, sq, h, d = q.shape
  hkv, dv = v.shape[2], v.shape[3]
  plan = fa.simt_plan(q.dtype, b, sq, h, hkv, d, dv)
  if plan["path"] == "ffma":
    key = ("ffma", plan["rows"] // 8, -(-dv // 64))
  else:
    key = ("mma", (dv // 8 + 1) // 2 * 2, 2 if plan["rows"] == 128 else 1)
  regs = build_info.get(key)
  plan = {**plan, "instance": list(key),
          "registers": None if regs is None else regs[0],
          "spill_bytes": None if regs is None else list(regs[1:])}
  text = (f"plan {plan['path']} <{key[1]}, {key[2]}>: {plan['rows']} rows "
          f"a block, {plan['keys']} keys a tile, {plan['stages']} stages, "
          f"{plan['smem']} shared bytes, {plan['blocks']} blocks, "
          + ("registers not in the build log" if regs is None else
             f"{regs[0]} registers, spills {regs[1]} B stored / {regs[2]} B "
             "loaded"))
  return plan, text


def simt_times(dev, fa, name_limit) -> tuple[list[dict], list[str]]:
  """Phase 5: the CUDA-core kernel at each shape of ``SIMT_TIME_CASES``:
  its launch plan (``simt_plan``, registers and spills from the build
  log), CUDA-event median and the profiler's device time of its kernel,
  the plain version, scaled_dot_product_attention on the same inputs
  (``enable_gqa``; under a window a boolean band mask; its backend, which
  for f32 cannot be flash or cuDNN, named from its longest kernel), SDPA's
  memory-efficient backend on k and v expanded to H heads outside the
  timed call (the f32 yardstick; neither SDPA call is on the port's path),
  and the bound."""
  from torch.nn.attention import SDPBackend, sdpa_kernel

  build_info = simt_build_info()
  rows, lines = [], []
  for (what, b, sq, skv, h, hkv, d, dv, dtype, causal, window, _,
       _) in SIMT_TIME_CASES:
    q, k, v = simt_inputs(dev, b, sq, skv, h, hkv, d, dv, dtype, seed=sq)
    plan, plan_text = simt_plan_text(fa, q, v, build_info)
    call = lambda: fa.flash_attention(q, k, v, causal, window=window)  # noqa
    bound_ms, bound_by = simt_bound(q, k, v, causal, window)
    ms = median_ms(call, 50, warmup=3)
    dev_ms = kernel_device_ms(call, "attention_simt", 50, bound_ms)
    plain_ms = median_ms(lambda: fa.flash_attention_plain(
        q, k, v, causal=causal, window=window), 10)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = band_mask(q, k, window)

    def sdpa():
      torch.nn.functional.scaled_dot_product_attention(
          qt, kt, vt, attn_mask=mask, is_causal=causal and not window,
          enable_gqa=h != hkv)

    lib_ms = median_ms(sdpa, 50, warmup=3)
    lib_dev_ms = kernel_device_ms(sdpa, "", 50, bound_ms)
    backend = sdpa_backend(sdpa)
    kx, vx = (t.repeat_interleave(h // hkv, dim=1) for t in (kt, vt))

    def sdpa_efficient():
      with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        torch.nn.functional.scaled_dot_product_attention(
            qt, kx, vx, attn_mask=mask, is_causal=causal and not window)

    try:
      eff_ms = median_ms(sdpa_efficient, 50, warmup=3)
      eff_dev_ms = kernel_device_ms(sdpa_efficient, "", 50, bound_ms)
      eff_text = (f"{eff_ms:.4f} ms (device {ms_text(eff_dev_ms)}, "
                  "profiler)")
    except RuntimeError as err:
      eff_ms = eff_dev_ms = None
      eff_text = f"refused ({str(err).splitlines()[0][:80]})"
    rows.append({"what": what, "shape": list(q.shape),
                 "kv_shape": list(k.shape), "width": [d, dv],
                 "dtype": str(dtype)[6:], "causal": causal,
                 "window": window, "plan": plan, "ms": ms,
                 "device_ms": dev_ms, "plain_ms": plain_ms,
                 "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
                 "library_backend": backend,
                 "efficient_expanded_ms": eff_ms,
                 "efficient_expanded_device_ms": eff_dev_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by})
    lines.append(
        f"times: {SIMT} {what} q {tuple(q.shape)} kv {tuple(k.shape)} Dv {dv}"
        f" {str(dtype)[6:]} {'window ' + str(window) if window else 'causal'}"
        f": {plan_text}; kernel {ms:.4f} ms (device {ms_text(dev_ms)} a "
        f"launch, profiler), plain {plain_ms:.4f} ms, "
        f"scaled_dot_product_attention {lib_ms:.4f} ms (device "
        f"{ms_text(lib_dev_ms)}, profiler; backend {backend}), its "
        f"memory-efficient backend on k, v expanded to {h} heads {eff_text},"
        f" bound {bound_ms:.6f} ms ({bound_by}), {share(bound_ms, dev_ms)} "
        f"of the kernel's device time [{name_limit}]")
  return rows, lines


SMOKE_BATCH, SMOKE_PROMPT, SMOKE_DECODE = 2, 16, 4
SMOKE_TRIM = 0.1
# The smoke phase's tolerance, c * (1 + max|cpu|), c per config: the card
# and the CPU run the same f32 model with other summation orders (cuBLAS
# and the CUDA-core attention kernel against the CPU's products and the
# plain version), so each output is off the exact one by the model's
# amplification of f32 roundings.  That amplification is measured on the
# CPU: the same prefill with the embedding (or the input frames) moved by
# one rounding (a factor 1 +- 2**-24 an element), its largest logit change
# over 1 + max|logit| is s.  Every layer adds roundings of that size at a
# few points (products, norms, softmax), each amplified at most as much as
# the input's: c = max(SMOKE_C_MIN, SMOKE_C_AMP * s), SMOKE_C_MIN the
# reference's cross-backend contract.  A random-weight smoke model can be
# chaotic (xlstm's scans amplify 10^4-fold): s carries that.  The updated
# parameters add 2 * lr: AdamW's first update of an element is lr * g /
# (|g| + eps) (plus the decay), at most lr in size, so a gradient that
# differs in the last bits where |g| is near eps moves it by up to 2 lr.
SMOKE_C_MIN = 1e-5
SMOKE_C_AMP = 16.0


def smoke_batch(cfg, rng) -> tuple[dict, np.ndarray]:
  """(the prefill's and train step's batch as numpy, from the pipeline at
  seed 0 with 10% of the targets corrupted: 2 prompts of 16 tokens, after
  the 8 patches for vision, or 16 frames for audio; the 4 decode inputs,
  token ids or frames, from ``rng``)."""
  from repro_torch.data.pipeline import pipeline_for_arch

  seq = SMOKE_PROMPT + (cfg.num_patches if cfg.frontend == "vision" else 0)
  batch = pipeline_for_arch(cfg, SMOKE_BATCH, seq, seed=SEED,
                            corrupt_fraction=0.1).batch_at(0)
  batch.pop("corrupt_mask")
  if cfg.frontend == "audio":
    decode = rng.standard_normal((SMOKE_DECODE, SMOKE_BATCH, cfg.d_model),
                                 dtype=np.float32)
  else:
    decode = rng.integers(0, cfg.vocab_size, (SMOKE_DECODE, SMOKE_BATCH))
  return batch, decode


def on_device(arrays: dict, device) -> dict:
  return {k: torch.from_numpy(np.asarray(v)).to(
      device=device, dtype=torch.int64 if np.asarray(v).dtype.kind in "iu"
      else None) for k, v in arrays.items()}


def smoke_run(cfg, model, batch_np, decode_np, kops, device) -> dict:
  """On ``device``: the prefill, 4 decode steps and one trimmed AdamW train
  step (trim 0.1, lr the default 3e-4) of ``model``; logits, the
  gradients of the step's loss, its loss, the updated parameters (on the
  CPU) and each kernel's launches a prefill, a decode step and a train
  step, each read after counts set to 0."""
  import dataclasses

  from repro_torch.launch import steps as ST
  from repro_torch.optim import adamw

  batch = on_device(batch_np, device)
  max_len = ST.prefill_length(cfg, batch) + SMOKE_DECODE
  out = {"launches": {}}
  kops.reset_all_launches()
  with torch.no_grad():
    logits, caches = ST.make_prefill_step(cfg, max_len)(model, batch)
    out["launches"]["prefill"] = kops.all_launches()
    seen = [logits]
    pos = ST.prefill_length(cfg, batch)
    decode = ST.make_decode_step(cfg)
    kops.reset_all_launches()
    for i in range(SMOKE_DECODE):
      inp = torch.from_numpy(decode_np[i]).to(
          device, torch.float32 if cfg.frontend == "audio" else torch.int64)
      logits, caches = decode(model, caches, inp, pos + i)
      seen.append(logits)
    out["launches"]["decode step"] = {
        k: n // SMOKE_DECODE for k, n in kops.all_launches().items()}
  out["logits"] = [x.float().cpu() for x in seen]
  tcfg = dataclasses.replace(cfg, loss_trim_fraction=SMOKE_TRIM)
  model.requires_grad_(True)
  params = dict(model.named_parameters())
  total, _ = ST.loss_from_batch(tcfg, model, batch)
  out["grads"] = {n: g.cpu() for n, g in zip(
      params, torch.autograd.grad(total, list(params.values())))}
  opt_cfg = adamw.AdamWConfig()
  state = ST.init_opt_state(tcfg, opt_cfg, params)
  kops.reset_all_launches()
  _, state, metrics = ST.make_train_step(tcfg, opt_cfg)(model, state, batch)
  out["launches"]["train step"] = kops.all_launches()
  out["loss"] = metrics["loss"].detach().float().cpu()
  out["params"] = {n: p.detach().cpu() for n, p in params.items()}
  out["lr"] = opt_cfg.lr
  return out


def smoke_launches_from_code(cfg) -> dict[str, dict[str, int]]:
  """Each kernel's launches a prefill, a decode step and a train step of a
  smoke config on the card, counted from the code: every GQA or MLA layer
  launches the CUDA-core attention kernel once a prefill and once a train
  step's forward (f32; remat "none": no recompute); every GQA layer
  launches decode_attention once a decode step (MLA decodes in plain ops);
  every MoE layer with the soft top-k
  router runs the gates kernel once a prefill and a decode step, and under
  autograd ``soft_topk_mask``'s ``pav_l2`` once a train step; the soft-LTS
  loss one more ``pav_l2``."""
  from repro_torch.models import transformer as T

  n_attn = attention_layers(cfg)
  n_gqa = sum(T.MIXERS[kind] == "attn" for kind in cfg.layer_kinds())
  routed = (sum(kind in T.MOE_KINDS for kind in cfg.layer_kinds())
            if cfg.router == "soft_topk" else 0)
  zero = {"pav_l2": 0, "pav_kl": 0, "soft_topk_gates": 0,
          "flash_attention": 0, SIMT: 0, "decode_attention": 0}
  return {"prefill": {**zero, "soft_topk_gates": routed, SIMT: n_attn},
          "decode step": {**zero, "soft_topk_gates": routed,
                          "decode_attention": n_gqa},
          "train step": {**zero, "pav_l2": routed + 1, SIMT: n_attn}}


def smoke_sensitivity(cfg, model, batch_np) -> float:
  """s: the CPU prefill's largest logit change over 1 + max|logit| when the
  model's input (the embedding table, or the frames) moves by one f32
  rounding, a factor 1 +- 2**-24 an element (seeded)."""
  import copy

  from repro_torch.launch import steps as ST

  batch = on_device(batch_np, "cpu")
  gen = torch.Generator().manual_seed(SEED)
  bump = lambda x: x * (1 + 2.0**-24 * (2 * torch.randint(  # noqa: E731
      0, 2, x.shape, generator=gen) - 1).to(x.dtype))
  moved = copy.deepcopy(model)
  if cfg.frontend == "audio":
    batch2 = {**batch, "embeds": bump(batch["embeds"])}
  else:
    batch2 = batch
    with torch.no_grad():
      moved.embed.table.copy_(bump(moved.embed.table))
  with torch.no_grad():
    a, _ = ST.make_prefill_step(cfg)(model, batch)
    b, _ = ST.make_prefill_step(cfg)(moved, batch2)
  return float((a - b).abs().max()) / (1 + float(a.abs().max()))


def smoke_phase(dev, kops, name_limit) -> tuple[list[str], dict]:
  """Fault F4's check: every config of ``all_smoke_configs()`` (f32, head
  width 16, MLA's (24, 16)) built on the CPU from seed 0 and the same
  weights carried to the card; on both a prefill of 2 prompts of 16
  tokens, 4 decode steps and one trimmed train step.  The card's logits,
  loss, gradients and updated parameters held to the CPU's within c * (1 +
  max|cpu|) (``SMOKE_C_*``), each kernel's launches a prefill, a decode
  step and a train step equal to the counts from the code, TF32 off for
  both products and cuDNN's convolutions."""
  import copy

  from repro_torch.configs.smoke import all_smoke_configs
  from repro_torch.models import transformer as T

  lines, counts, failed = [], {}, []
  rng = np.random.default_rng([SEED, 24])
  cudnn_tf32 = torch.backends.cudnn.allow_tf32
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  try:
    for cfg in all_smoke_configs():
      t0 = time.perf_counter()
      batch_np, decode_np = smoke_batch(cfg, rng)
      model = T.init_params(cfg, SEED, "cpu")
      card_model = copy.deepcopy(model).to(dev)
      s = smoke_sensitivity(cfg, model, batch_np)
      c = max(SMOKE_C_MIN, SMOKE_C_AMP * s)
      cpu = smoke_run(cfg, model, batch_np, decode_np, kops, "cpu")
      card = smoke_run(cfg, card_model, batch_np, decode_np, kops, dev)
      torch.cuda.synchronize()
      worst = {}

      def held(what, got, want, c_what):
        err = float((got.double() - want.double()).abs().max())
        tol = c_what * (1 + float(want.abs().max()))
        ratio = err / tol
        worst[what] = max(worst.get(what, 0.0), ratio)
        if not (bool(torch.isfinite(got).all()) and err <= tol):
          failed.append(f"{cfg.name} {what}: |card - cpu| {err:.3e} > "
                        f"{tol:.3e}")

      for i, (a, b) in enumerate(zip(card["logits"], cpu["logits"])):
        held("logits", a, b, c)
      held("loss", card["loss"], cpu["loss"], c)
      for n in cpu["grads"]:
        held("gradients", card["grads"][n], cpu["grads"][n], c)
      for n in cpu["params"]:
        held("parameters", card["params"][n], cpu["params"][n],
             c + 2 * cpu["lr"])
      want = smoke_launches_from_code(cfg)
      counts[cfg.name] = card["launches"]
      if card["launches"] != want:
        failed.append(f"{cfg.name}: launches {card['launches']}, counted "
                      f"from the code {want}")
      lines.append(
          f"smoke: {cfg.name} (f32, head width {cfg.head_dim}"
          f"{', MLA' if cfg.kv_lora_rank else ''}): card against CPU from "
          f"seed {SEED}'s weights, prefill {SMOKE_BATCH} x {SMOKE_PROMPT} + "
          f"{SMOKE_DECODE} decode steps + one train step (trim "
          f"{SMOKE_TRIM}): worst |card - cpu| / (c (1 + max|cpu|)) "
          + ", ".join(f"{k} {v:.3f}" for k, v in worst.items())
          + f" (limit 1; c {c:.3e} from s {s:.3e}; parameters c + 2 lr); "
          f"loss card {float(card['loss']):.7f} cpu {float(cpu['loss']):.7f};"
          f" launches {card['launches']}; {time.perf_counter() - t0:.1f} s")
      del card_model
  finally:
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
  for line in lines:
    say(line)
  check(not failed, "smoke: " + "; ".join(failed))
  return lines, counts


# The example programs as the card runs them, with the launches each makes
# counted from its code (``example_launches``).
EXAMPLE_RUNS = {
    "quickstart": [],
    "label_ranking": [],
    "robust_lm_training": ["--full", "--steps", "300"],
    "moe_soft_router": [],
}


def example_launches(name: str, res: dict, mod) -> dict[str, int]:
  """Each kernel's launches in one run of an example program on the card,
  counted from its code and what its ``main`` returned: label ranking one
  ``pav_l2`` a step of the soft Spearman loss (the ablation none); robust
  LM training one CUDA-core attention launch a layer each training step
  and each clean-token evaluation, and under the trim one ``pav_l2`` a
  step; the MoE example a CUDA-core attention launch a layer each training
  step (both routers), ``pav_l2`` a layer a step for the soft router's
  training gates, and the gates kernel once for its load CV, once a layer
  for the generation's prefill and for each of its decode steps (plus the
  prefill's attention and decode_attention once a layer a decode step); quickstart one ``pav_l2`` a soft_rank / soft_sort
  / soft_topk_mask / soft_quantile call (7 l2) and one ``pav_kl`` (the KL
  rank)."""
  zero = {"pav_l2": 0, "pav_kl": 0, "soft_topk_gates": 0,
          "flash_attention": 0, SIMT: 0, "decode_attention": 0}
  if name == "quickstart":
    return {**zero, "pav_l2": 7, "pav_kl": 1}
  if name == "label_ranking":
    return {**zero, "pav_l2": res["steps"]}
  if name == "robust_lm_training":
    layers = mod.make_cfg(res["full"], 0.0).num_layers
    per_run = res["steps"] + len(res["baseline"]["eval_steps"])
    return {**zero, SIMT: 2 * layers * per_run, "pav_l2": res["steps"]}
  layers, steps = mod.make_cfg("soft_topk").num_layers, res["steps"]
  return {**zero, SIMT: 2 * layers * steps + layers,
          "pav_l2": layers * steps,
          "soft_topk_gates": 1 + layers * (1 + mod.GENERATE),
          "decode_attention": layers * mod.GENERATE}


def examples_phase(dev, kops, name_limit) -> tuple[list[str], dict]:
  """The four example programs on the card through their ``main``, with
  the launch counts set to 0 before each and read after (held to
  ``example_launches``), wall seconds and peak memory (above what was
  allocated before the program); quickstart's values held to the same
  program on the CPU within 1e-5 * (1 + max|cpu|)."""
  import importlib

  lines, rows = [], {}
  cudnn_tf32 = torch.backends.cudnn.allow_tf32
  torch.backends.cudnn.allow_tf32 = False
  try:
    for name, argv in EXAMPLE_RUNS.items():
      mod = importlib.import_module(f"repro_torch.examples.{name}")
      gc.collect()
      torch.cuda.empty_cache()
      held = torch.cuda.memory_allocated(dev)
      torch.cuda.reset_peak_memory_stats(dev)
      kops.reset_all_launches()
      t0 = time.perf_counter()
      res = mod.main(argv + ["--device", "cuda"])
      torch.cuda.synchronize()
      wall = time.perf_counter() - t0
      launches = kops.all_launches()
      peak = (torch.cuda.max_memory_allocated(dev) - held) / 2**30
      want = example_launches(name, res, mod)
      check(launches == want, f"{name}: launches {launches}, counted from "
            f"the code {want}")
      steps = 2 * res.get("steps", 0)   # two trainings each, or none
      row = {"wall_s": wall, "peak_gib": peak, "launches": launches,
             "steps": steps, "steps_per_s": steps / wall if steps else None}
      if name == "quickstart":
        cpu = mod.main(["--device", "cpu"])
        errs = [close(torch.tensor(res[k]), torch.tensor(cpu[k]))
                for k in cpu if k not in ("seconds", "ranks_shape")]
        check(res["ranks_shape"] == cpu["ranks_shape"], "quickstart shape")
        text = (f"every value within 1e-5 * (1 + max|cpu|) of the CPU run "
                f"(worst |card - cpu| {max(errs):.3e}); soft_rank eps 1 "
                f"{res['soft_rank_eps1']}, soft median "
                f"{res['soft_median']:.6f}")
      elif name == "label_ranking":
        rho = (res["rho_projection"], res["rho_no_projection"])
        check(all(0.5 < r <= 1.0 for r in rho), f"label ranking rho {rho}")
        row.update(rho_projection=rho[0], rho_no_projection=rho[1])
        text = (f"held-out Spearman rho {rho[0]:.4f} with the projection, "
                f"{rho[1]:.4f} without")
      elif name == "robust_lm_training":
        base, lts = res["baseline"]["clean"][-1], res["soft_lts"]["clean"][-1]
        check(all(map(math.isfinite, res["baseline"]["train"]
                      + res["soft_lts"]["train"] + [base, lts])),
              "robust LM: non-finite losses")
        row.update(clean_baseline=base, clean_soft_lts=lts,
                   params=res["params"])
        text = (f"{res['params']:,} f32 parameters, {res['steps']} steps "
                f"each: clean-token loss baseline {base:.4f}, soft-LTS "
                f"{lts:.4f}; final train loss baseline "
                f"{res['baseline']['train'][-1]:.4f}, soft-LTS "
                f"{res['soft_lts']['train'][-1]:.4f}")
      else:
        for router in ("softmax_topk", "soft_topk"):
          check(math.isfinite(res[router]["loss"]), f"MoE {router} loss")
        row.update({r: {"loss": res[r]["loss"], "cv": res[r]["cv"]}
                    for r in ("softmax_topk", "soft_topk")},
                   tokens=res["tokens"])
        text = ("; ".join(f"{r} final loss {res[r]['loss']:.4f} expert-load"
                          f" CV {res[r]['cv']:.4f}"
                          for r in ("softmax_topk", "soft_topk"))
                + f"; sampled tokens {res['tokens'][0]}")
      rows[name] = row
      lines.append(f"examples: {name} {' '.join(argv)}: {text}; wall "
                   f"{wall:.2f} s, {row['steps_per_s'] or 0:.1f} steps/s, "
                   f"peak {peak:.3f} GiB; launches {launches} [{name_limit}]")
  finally:
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
  for line in lines:
    say(line)
  return lines, rows


# The paper's quality experiments, in the reference's order
# (``benchmarks/run.py``); how far a row may part between the card and the
# CPU is ``repro_torch.experiments.BANDS``, as in the tests.
EXPERIMENTS = ("bench_topk", "bench_label_ranking", "bench_lts")
# Each experiment's losses that make one isotonic solve a step, and which.
EXPERIMENT_SOLVES = {"hard_lts": "pav_l2", "soft_lts": "pav_l2",
                     "soft_rank_q": "pav_l2", "soft_rank_e": "pav_kl",
                     "kl_direct": "pav_kl", "soft_topk_q": "pav_l2",
                     "soft_topk_e": "pav_kl"}


def experiment_on_cpu(name: str, kinds: tuple[str, ...] | None = None):
  """Worker process: the experiment ``name`` as ``main(["--device",
  "cpu"])`` runs it (with ``kinds``, only those losses of the top-k
  experiment), its isotonic solves by the divide and conquer (``scan``,
  the kernels' plain version), its CSV rows not printed.  Returns the rows
  and the seconds it took."""
  import importlib
  import io
  sys.path.insert(0, str(ROOT / "src"))
  from repro_torch.core import use_impl
  torch.set_num_threads(1)
  mod = importlib.import_module(f"repro_torch.experiments.{name}")
  t0 = time.perf_counter()
  with use_impl("scan"), contextlib.redirect_stdout(io.StringIO()):
    rows = (mod.run(torch.device("cpu"), kinds) if kinds
            else mod.main(["--device", "cpu"]))
  return rows, time.perf_counter() - t0


def experiment_cpu_jobs(pool) -> dict[str, list]:
  """The three experiments on the CPU workers, the top-k one a job per
  loss (its all-pairs loss alone takes about 2 minutes of one core), the
  longest first."""
  topk = ("allpairs", "soft_topk_e", "soft_topk_q", "cross_entropy")
  jobs = {"bench_topk": [pool.submit(experiment_on_cpu, "bench_topk",
                                     (kind,)) for kind in topk]}
  for name in ("bench_lts", "bench_label_ranking"):
    jobs[name] = [pool.submit(experiment_on_cpu, name)]
  return jobs


def experiment_metrics(row: dict) -> tuple[str, ...]:
  return (("objective", "frac_to_LS") if "objective" in row else
          tuple(m for m in ("r2", "spearman_rho", "test_acc") if m in row))


def experiment_launches(name: str, rows: list[dict]) -> dict[str, int]:
  """Each kernel's launches in one run of an experiment on the card,
  counted from its code and its rows: one isotonic solve a step of the
  losses in ``EXPERIMENT_SOLVES`` (the forward's; the Lemma 2 backward
  solves none), ``pav_l2`` for the quadratic ones and ``pav_kl`` for the
  entropic ones and r~_E; Fig. 6 one ``pav_l2`` an eps and one for its
  hard-LTS endpoint; least squares, Huber, no projection, cross-entropy
  and all-pairs none."""
  counts = {"pav_l2": 0, "pav_kl": 0, "soft_topk_gates": 0,
            "flash_attention": 0, SIMT: 0, "decode_attention": 0}
  for row in rows:
    kind = row["name"].split("/")[1]
    if row["name"].startswith("fig6_"):
      counts["pav_l2"] += 1
    elif kind in EXPERIMENT_SOLVES:
      counts[EXPERIMENT_SOLVES[kind]] += row["steps"]
  if name == "bench_lts":
    counts["pav_l2"] += 1
  return counts


@contextlib.contextmanager
def captured_solves(dispatch):
  """The card's isotonic solves (``dispatch``'s ``cuda`` entries, the PAV
  kernels' wrappers) with copies kept of the inputs and output of the
  first and the last call at each (kernel, shape).  Yields them as
  {(kernel, shape): [first, last]}, each (inputs, output)."""
  seen: dict = {}
  saved = {}
  for reg in ("l2", "kl"):
    key = ("isotonic", reg, "cuda")
    fn = saved[key] = dispatch._REGISTRY[key]

    def solve(*args, _fn=fn, _kname=f"pav_{reg}"):
      out = _fn(*args)
      copy = (tuple(a.clone() for a in args), out.clone())
      seen.setdefault((_kname, tuple(out.shape)), [copy, copy])[1] = copy
      return out

    dispatch._REGISTRY[key] = solve
  try:
    yield seen
  finally:
    dispatch._REGISTRY.update(saved)


def experiments_phase(dev, kops, pav_scan, record,
                      name_limit) -> dict[str, dict]:
  """The paper's three experiments on the card through their ``main`` at
  the reference's sizes and steps (their CSV rows printed as the reference
  prints them), the launch counts set to 0 before each and read after
  (held to ``experiment_launches``); every row finite; wall seconds,
  steps/s and peak memory (above what was allocated before).  The PAV
  kernels are held on the run's own solves: the first and the last call
  at each shape against ``pav_l2_scan`` / ``pav_kl_scan`` on the same
  inputs, as phase 3 holds them (bit for bit, the same blocks).  Keeping
  those copies adds a few copy launches to each step's wall."""
  import importlib

  from repro_torch.kernels import dispatch

  out = {}
  for name in EXPERIMENTS:
    mod = importlib.import_module(f"repro_torch.experiments.{name}")
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    kops.reset_all_launches()
    with captured_solves(dispatch) as solves:
      t0 = time.perf_counter()
      rows = mod.main(["--device", "cuda"])
      torch.cuda.synchronize()
      wall = time.perf_counter() - t0
    launches = kops.all_launches()
    peak = (torch.cuda.max_memory_allocated(dev) - held) / 2**30
    want = experiment_launches(name, rows)
    check(launches == want, f"{name}: launches {launches}, counted from "
          f"the code {want}")
    check(all(math.isfinite(row[m]) for row in rows
              for m in ("us_per_call", *experiment_metrics(row))),
          f"{name}: a row is not finite")
    check(all(np.isfinite(v).all() for row in rows
              for v in row.get("weights", {}).values()),
          f"{name}: a row's weights are not finite")
    check(sorted(k for k, n in want.items() if n) ==
          sorted({k for k, _ in solves}),
          f"{name}: solves captured {sorted(solves)}, launches {want}")
    held_text = []
    for (kname, shape), calls in sorted(solves.items()):
      plain = getattr(pav_scan, f"{kname}_scan")
      for which, (args, got) in zip(("first", "last"), calls):
        reason = KL_ON_CARD if kname == "pav_kl" else None
        held_text.append(
            f"{kname} {shape} {which} call: " +
            hold(kname, f"{name} {shape} {which}", got, plain(*args),
                 record, reason))
    steps = sum(row.get("steps", 0) for row in rows)
    out[name] = {"rows": rows, "wall_s": wall, "steps": steps,
                 "steps_per_s": steps / wall, "peak_gib": peak,
                 "launches": launches}
    text = "; ".join(
        row["name"].split("/", 1)[1] + " " + ", ".join(
            f"{m} {row[m]:.6f}" for m in experiment_metrics(row))
        for row in rows)
    say(f"experiments: {name} on the card: {text}; wall {wall:.2f} s, "
        f"{steps} steps, {steps / wall:.1f} steps/s, peak {peak:.4f} GiB; "
        f"launches {launches} [{name_limit}]")
    say(f"experiments: {name}'s own solves, kernel against the plain "
        f"divide and conquer on the card: {'; '.join(held_text)}")
  return out


def experiments_cpu_checks(card: dict[str, dict], futures) -> None:
  """Every row of the card's runs against the same row of the CPU's, each
  metric and the final weights within ``repro_torch.experiments``'s
  ``band``."""
  from repro_torch.experiments import BANDS, band, weights_apart

  for name, jobs in futures.items():
    cpu, seconds = {}, []
    for job in jobs:
      rows, sec = job.result()
      cpu.update((row["name"], row) for row in rows)
      seconds.append(sec)
    rows = card[name]["rows"]
    check(sorted(cpu) == sorted(row["name"] for row in rows),
          f"{name}: the CPU's rows are not the card's")
    worst: dict[str, float] = {}
    for row in rows:
      ref = cpu[row["name"]]
      for m in experiment_metrics(row):
        err = abs(row[m] - ref[m])
        check(math.isfinite(ref[m])
              and err <= band(m, ref[m], row.get("n_test")),
              f"{name} {row['name']} {m}: card {row[m]!r}, cpu {ref[m]!r}")
        worst[m] = max(worst.get(m, 0.0), err)
      if "weights" in row:
        err, tol = weights_apart(row["weights"], ref["weights"])
        check(err <= tol, f"{name} {row['name']} weights: max |card - cpu| "
              f"{err:.3e}, band {tol:.3e}")
        rel = err / (tol / BANDS["weights"])
        worst["weights / (1 + max|cpu|)"] = max(
            worst.get("weights / (1 + max|cpu|)", 0.0), rel)
    say(f"experiments: {name} card against the CPU (divide and conquer, "
        f"{len(jobs)} worker job(s), {' + '.join(f'{s:.1f}' for s in seconds)}"
        f" s of one core): every row and its final weights within their "
        f"bands; worst |card - cpu| "
        + ", ".join(f"{m} {e:.3e}" for m, e in worst.items()))


def paper_claims(card: dict[str, dict]) -> str:
  """The paper's four claims on the card's rows, each reproduced or not:
  Table 1, a soft-rank loss above no projection at both noise levels;
  Fig. 6, frac_to_LS within 0.1 of 0 at eps 1e-4 and of 1 at 1e5; Fig. 7,
  hard and soft LTS above least squares' R^2 at every outlier fraction
  from 0.1; Fig. 4, each soft top-k loss's accuracy within 5 points of
  cross-entropy's at both class counts."""
  rows = {row["name"]: row for run in card.values() for row in run["rows"]}

  def verdict(ok: bool) -> str:
    return "reproduced" if ok else "NOT reproduced"

  parts = []
  t1 = []
  for noise in (0.25, 1.0):
    base = rows[f"table1_label_ranking/no_projection/noise={noise}"]
    soft = {k: rows[f"table1_label_ranking/{k}/noise={noise}"]
            ["spearman_rho"] for k in ("soft_rank_q", "soft_rank_e",
                                        "kl_direct")}
    best = max(soft, key=soft.get)
    t1.append((soft[best] > base["spearman_rho"],
               f"noise {noise}: {best} {soft[best]:.4f} against "
               f"{base['spearman_rho']:.4f}"))
  parts.append(f"Table 1 {verdict(all(ok for ok, _ in t1))} ("
               + "; ".join(text for _, text in t1) + ")")
  lo = rows["fig6_interpolation/eps=0.0001"]["frac_to_LS"]
  hi = rows["fig6_interpolation/eps=100000"]["frac_to_LS"]
  parts.append(f"Fig. 6 {verdict(lo < 0.1 and hi > 0.9)} (frac_to_LS "
               f"{lo:.4f} at eps 1e-4, {hi:.4f} at 1e5)")
  f7 = []
  for frac in (0.1, 0.2, 0.3, 0.4):
    r = {k: rows[f"fig7_robust_regression/{k}/outliers={frac}"]["r2"]
         for k in ("least_squares", "hard_lts", "soft_lts")}
    f7.append((r["hard_lts"] > r["least_squares"]
               and r["soft_lts"] > r["least_squares"],
               f"{frac}: hard {r['hard_lts']:.4f}, soft {r['soft_lts']:.4f},"
               f" LS {r['least_squares']:.4f}"))
  parts.append(f"Fig. 7 {verdict(all(ok for ok, _ in f7))} ("
               + "; ".join(text for _, text in f7) + ")")
  f4 = []
  for n in (10, 100):
    ce = rows[f"fig4_topk/cross_entropy/classes={n}"]["test_acc"]
    for k in ("soft_topk_q", "soft_topk_e"):
      acc = rows[f"fig4_topk/{k}/classes={n}"]["test_acc"]
      f4.append((ce - acc <= 0.05, f"{k} {acc:.4f} at {n} classes"))
    f4[-1] = (f4[-1][0], f4[-1][1] + f" (cross-entropy {ce:.4f})")
  parts.append(f"Fig. 4 {verdict(all(ok for ok, _ in f4))} ("
               + "; ".join(text for _, text in f4) + ")")
  return "experiments: the paper's claims on the card: " + "; ".join(parts)


def kernels_summary(*, launches, max_err, kernel_rows, serve_counts,
                    serve_rows, dense_row, grok_row, grok_gate_rows,
                    full_rows, audio_row, train_launches, train_rows,
                    engine_runs, engine_rows, option_rows,
                    mesh_launches, simt_rows, smoke_counts,
                    example_rows, simt_serve, experiment_runs,
                    decode_rows) -> list[dict]:
  """The ``{"kernels": [...]}`` line's entries: every kernel with the
  contract's keys and its launches by path (``serve_launches`` and
  ``train_launches`` by model).  ``launches`` is each kernel's main path:
  the operators' for the PAV kernels, the deepseek server's for the gates
  and attention.  Attention's top-level numbers stay those of the MLA
  width at the deepseek prefill, as in earlier lines; ``widths`` gives
  each built width's row (MLA, the dense width at the llama prefill, grok's
  at its prefill, gemma's at its global layers' prefill with the local
  layers' windowed one under ``local``, stablelm's (80, 80) at its prefill,
  recurrentgemma's (256, 256) at G = 10 at its local layers' windowed
  prefill, llava's (128, 128) at G = 4 at its 1088-position prefill,
  musicgen's (64, 64) at G = 1 and tinyllama's (64, 64) at G = 8 at their
  prefills; xlstm has no attention)
  ``mesh_launches`` counts each kernel's launches in the mesh phase's
  sharded runs, by run, ``experiment_launches`` in the paper's
  experiments, by experiment.  ``widths`` gives each width
  with its own launches, error and training shape's times (none for grok,
  which is not trained; recurrentgemma's and llava's, whose train runs are
  checks only, the attention alone; gemma's at its first, windowed,
  layer); ``options``
  the kernel with a soft-cap, a query offset and a window without
  ``causal`` beside the same shapes without them.  The gates' top-level
  numbers stay deepseek's (4096, 64); ``shapes`` adds grok's (4096, 8) and
  (8, 8).  The CUDA-core attention kernel's main path is the example
  programs (``launches``: their sum); ``example_launches`` by program,
  ``smoke_launches`` by smoke config a prefill, decode step and train step
  (each read after counts set to 0), the bf16 paths' zeros under
  ``serve_launches`` and ``train_launches``; its top-level numbers are
  the robust LM example's --full shape, ``rows`` every shape timed.
  ``decode_attention`` (no TPU kernel: the reference decodes in plain ops)
  has grok's decode path as its main path (``launches``: the grok
  server's), its top-level numbers at the decode cell's shape with a
  cache_len of 3300, ``rows`` each cache_len timed."""

  def by_arch(counts: dict, kname: str) -> dict[str, int]:
    return {arch: c[kname] for arch, c in counts.items()}

  def paths(kname: str) -> dict:
    return {"serve_launches": by_arch(serve_counts, kname),
            "train_launches": by_arch(train_launches, kname),
            "engine_launches": engine_runs["default"]["launches"][kname],
            "engine_all_ops_launches":
                engine_runs["all ops"]["launches"][kname],
            "mesh_launches": by_arch(mesh_launches, kname),
            "experiment_launches": {name: run["launches"][kname] for
                                    name, run in experiment_runs.items()}}

  kernels = []
  for kname in ("pav_l2", "pav_kl"):
    row = kernel_rows[(kname, HEADLINE)]
    kernels.append({
        "name": kname, "route": "cuda", "source": SOURCES[kname],
        "replaces": REPLACES[kname], "launches": launches[kname],
        "max_abs_err": max_err[kname], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": None,
        "shape": list(HEADLINE), **paths(kname),
        "engine_shape": list(ENGINE_KERNEL_SHAPE), **engine_rows[kname]})
  kernels.append({
      "name": "soft_topk_gates", "route": "cuda",
      "source": SOURCES["soft_topk_gates"],
      "replaces": REPLACES["soft_topk_gates"],
      "launches": serve_counts[ARCH]["soft_topk_gates"],
      "max_abs_err": max_err["soft_topk_gates"],
      **serve_rows["soft_topk_gates"], **paths("soft_topk_gates"),
      "shapes": [{**row, "arch": GROK_ARCH, "k": 2} for row in
                 grok_gate_rows]})
  widths = [
      {**serve_rows["flash_attention"], "arch": ARCH,
       "launches": serve_counts[ARCH]["flash_attention"],
       "train_launches": train_launches[ARCH]["flash_attention"],
       "max_abs_err": max_err["flash_attention"],
       "train_shape": train_rows[ARCH]},
      {**dense_row, "arch": DENSE_ARCH,
       "launches": serve_counts[DENSE_ARCH]["flash_attention"],
       "train_launches": train_launches[DENSE_ARCH]["flash_attention"],
       "max_abs_err": max_err["flash_attention 64x64"],
       "train_shape": train_rows[DENSE_ARCH]},
      {**grok_row, "arch": GROK_ARCH,
       "launches": serve_counts[GROK_ARCH]["flash_attention"],
       "train_launches": None,
       "max_abs_err": max_err["flash_attention 128x128"],
       "train_shape": None}]
  for arch, run in FULL_SERVE_RUNS.items():
    if full_rows[arch] is None:
      continue
    widths.append({
        **full_rows[arch], "arch": arch,
        "launches": serve_counts[arch]["flash_attention"],
        "train_launches": train_launches[arch]["flash_attention"],
        "max_abs_err": max_err[run["err_key"]],
        "train_shape": train_rows.get(arch)})
  widths.append({
      **audio_row, "arch": MUSICGEN_ARCH,
      "launches": serve_counts[MUSICGEN_ARCH]["flash_attention"],
      "train_launches": train_launches[MUSICGEN_ARCH]["flash_attention"],
      "max_abs_err": max_err["flash_attention 64x64 G1"],
      "train_shape": train_rows.get(MUSICGEN_ARCH)})
  kernels.append({
      "name": "flash_attention", "route": "cuda",
      "source": SOURCES["flash_attention"],
      "replaces": REPLACES["flash_attention"],
      **{k: v for k, v in widths[0].items()
         if k not in ("arch", "train_shape", "train_launches")},
      **paths("flash_attention"), "widths": widths,
      "options": option_rows})
  head = next(r for r in simt_rows if r["what"] == "robust LM --full")
  kernels.append({
      "name": SIMT, "route": "cuda", "source": SOURCES[SIMT],
      "replaces": REPLACES[SIMT],
      "launches": (sum(r["launches"][SIMT] for r in example_rows.values())
                   + simt_serve["launches"]),
      "max_abs_err": max(max_err[SIMT], simt_serve["max_abs_err"]),
      **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "shape", "dtype",
                              "library_backend")},
      "example_launches": {name: r["launches"][SIMT]
                           for name, r in example_rows.items()},
      "smoke_launches": {name: {what: c[SIMT] for what, c in runs.items()}
                         for name, runs in smoke_counts.items()},
      "serve": simt_serve,
      **paths(SIMT), "rows": simt_rows})
  head = next(r for r in decode_rows if r["cache_len"] == 3300)
  kernels.append({
      "name": "decode_attention", "route": "cuda",
      "source": SOURCES["decode_attention"],
      "replaces": REPLACES["decode_attention"],
      "launches": serve_counts[GROK_ARCH]["decode_attention"],
      "max_abs_err": None,
      **{k: head[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms", "library_backend",
                              "shape", "cache_len")},
      "example_launches": {name: r["launches"]["decode_attention"]
                           for name, r in example_rows.items()},
      "smoke_launches": {name: {what: c["decode_attention"]
                                for what, c in runs.items()}
                         for name, runs in smoke_counts.items()},
      **paths("decode_attention"), "rows": decode_rows})
  return kernels


def main() -> int:
  # 1. device ---------------------------------------------------------------
  if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: CUDA is not available\n")
    return 2
  sys.path.insert(0, str(ROOT / "src"))
  import repro_torch as rt
  from repro_torch.kernels import _build, ops as kops, pav, pav_scan
  from repro_torch.kernels import segment_vjp
  from repro_torch.kernels import flash_attention as fa
  from repro_torch.kernels import soft_topk as st
  from repro_torch.launch import serve

  dev = torch.device("cuda", 0)
  torch.cuda.set_device(dev)
  # f32 products in full f32 (the default, stated): the router logits and
  # the f32 comparisons below.
  torch.backends.cuda.matmul.allow_tf32 = False
  name_limit = card()
  say(name_limit)
  say(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
      f"on {torch.cuda.get_device_name(0)}")

  # 2. build ----------------------------------------------------------------
  t0 = time.perf_counter()
  libs = _build.build_all()
  say(f"build: {sorted(libs)} in {time.perf_counter() - t0:.2f} s; by "
      "source (nvcc start to exit, all in parallel): " + ", ".join(
          f"{name} {sec:.2f} s" for name, sec in
          sorted(_build.BUILD_SECONDS.items())))
  for log in _build.BUILD_LOG.values():
    for line in log.splitlines():
      if "registers" in line or "spill" in line:
        say("build:", line.strip())

  clock("build")
  # 3. kernels against their plain versions ------------------------------
  rng = np.random.default_rng(SEED)
  # The main path's inputs (phase 4).
  theta_np = {shape: rng.normal(size=shape) for shape in SHAPES}
  target_np = {shape: rng.permuted(np.broadcast_to(
      np.arange(1, shape[1] + 1, dtype=np.float64), shape), axis=-1)
      for shape in SHAPES}
  cot_np = {shape: rng.normal(size=shape) for shape in SHAPES}
  tokens_np = rng.gamma(2.0, 1.25, size=(8, TOKENS // 8))  # per-token CE
  # The PAV kernels are held against their plain versions pav_l2_scan /
  # pav_kl_scan and within the contract against the stack machine, kept
  # apart.
  max_err = {"pav_l2": 0.0, "pav_l2 vs stack": 0.0, "pav_kl": 0.0,
             "pav_kl vs stack": 0.0, "soft_topk_gates": 0.0,
             "flash_attention": 0.0, "flash_attention 64x64": 0.0,
             "flash_attention 128x128": 0.0, "flash_attention 256x256": 0.0,
             "flash_attention 256x256 G10": 0.0,
             "flash_attention 80x80": 0.0, "flash_attention 128x128 G4": 0.0,
             "flash_attention 64x64 G1": 0.0,
             "flash_attention 64x64 G8": 0.0, SIMT: 0.0}

  def record(kname, out, ref):
    err = close(out, ref)
    max_err[kname] = max(max_err[kname], err)
    return err

  for rows, n in ((128, 1000), (128, 2048)):
    for kind in ("random", "ties", "soft_rank"):
      y, (s, w) = solver_inputs(rng, rows, n, kind)
      errs = []
      for kname, args in (("pav_l2", (y,)), ("pav_kl", (s, w))):
        args = [to_dev(a, dev) for a in args]
        out = getattr(pav, kname)(*args)
        errs.append(record(f"{kname} vs stack", out,
                           getattr(pav, f"{kname}_stack")(*args)))
      say(f"kernels: ({rows}, {n}) {kind}: max |kernel - plain| on the card"
          f" l2 {errs[0]:.3e} kl {errs[1]:.3e} (tol 1e-5 * (1 + max|plain|))")

  serve_kernel_checks(rng, dev, st, fa, record, max_err)
  simt_kernel_checks(dev, fa, kops, max_err)

  # At (128, 10000) and (1, 2**20) the stack machine takes tens of seconds
  # per call: it runs on a CPU copy in worker processes (spawned, so they
  # never touch CUDA), the longest first (the adversarial rows' plain
  # divide and conquer, put first by pav_scan_checks), while phase 4 runs
  # on the card.  Job: (kernel, what, shape, kernel output, plain function,
  # inputs).
  jobs = []
  for rows, n in ((1, TOKENS), (128, 10000)):
    _, (rs, rw) = solver_inputs(rng, rows, n, "random")
    rs, rw = to_dev(rs, dev), to_dev(rw, dev)
    if rows == 1:
      ms, mw = main_solver_inputs(None, to_dev(tokens_np, dev))
    else:
      ms, mw = main_solver_inputs(to_dev(theta_np[(rows, n)], dev), None)
    for kind, (s, w) in (("random", (rs, rw)), ("main", (ms, mw))):
      for kname, args in (("pav_l2", ((s - w).contiguous(),)),
                          ("pav_kl", (s, w))):
        out = getattr(pav, kname)(*args).cpu()
        jobs.append((kname, f"{kind} input, plain stack machine", (rows, n),
                     out, f"{kname}_stack",
                     tuple(a.cpu().numpy() for a in args)))
  pav_scan_checks(rng, dev, pav, pav_scan, theta_np, tokens_np, record, jobs)
  engine_kernel_checks(dev, pav, pav_scan, record,
                       np.random.default_rng([SEED, 3]))

  pool = ProcessPoolExecutor(max_workers=CPU_WORKERS,
                             mp_context=multiprocessing.get_context("spawn"))
  try:
    # The engine's streams as unpadded calls on the CPU go first: the
    # engine phase's comparisons wait for them.
    engine_futures = engine_cpu_jobs(pool)
    experiment_futures = experiment_cpu_jobs(pool)
    futures = [pool.submit(plain_on_cpu, job[4], job[5]) for job in jobs]
    token_future = pool.submit(token_loss_on_cpu, tokens_np)
    say(f"kernels: {len(jobs)} comparisons at (1, {TOKENS}) and (128, 10000)"
        f" and the token loss on the CPU handed to {CPU_WORKERS} CPU worker "
        "processes")

    clock("phase 3 on the card")
    # 4. main path ------------------------------------------------------------
    launches, token_run = main_path(rt, pav, dev, theta_np, target_np,
                                    cot_np, tokens_np)
    say("main: f64 on the card (the scan backend) vs the CPU, within 1e-10 "
        "* (1 + max|CPU|), no PAV launch: " + "; ".join(
            f64_on_the_card(rt, pav, dev, np.random.default_rng([SEED, 2]))))
    clock("phase 4")

    # plan --------------------------------------------------------------------
    for line in plan_phase(rt, pav, pav_scan, dev, record, name_limit):
      say(line)
    clock("plan")

    # engine ------------------------------------------------------------------
    engine_rng = np.random.default_rng([SEED, 16])
    engine_runs = engine_path(rt, dev, serve, kops, engine_rng)
    # The serving path runs on the card while the CPU workers finish.
    serve_res, serve_launches, serve_rec, serve_err = serve_path(
        dev, serve, kops, st, fa)
    for kname, err in serve_err.items():
      max_err[kname] = max(max_err[kname], err)

    clock("phase 4, the engine and the deepseek server")
    # The example programs run on the card while the CPU workers finish
    # (their peaks are their own, above what the server holds).
    _, example_rows = examples_phase(dev, kops, name_limit)
    clock("examples")
    experiment_runs = experiments_phase(dev, kops, pav_scan, record,
                                        name_limit)
    clock("experiments")
    t0 = time.perf_counter()
    for (kname, what, shape, out, fn_name, _), future in zip(jobs, futures):
      ref, seconds = future.result()
      stack = fn_name.endswith("_stack")
      # Bit for bit: the l2 divide and conquer (adds round alike on CPU
      # and card).  Blocks: every comparison but l2's with the stack
      # machine, whose sums of 1e4 values differ in the last bits.
      reason = ("the stack machine pools in another order" if stack
                else KL_ON_CPU if kname == "pav_kl" else None)
      text = hold(f"{kname} vs stack" if stack else kname,
                  f"{shape} {what}", out, torch.from_numpy(ref), record,
                  reason, blocks=kname == "pav_kl" or not stack)
      say(f"kernels: {kname} {shape} {what}, on a CPU copy: {text}; plain "
          f"{seconds:.1f} s on one CPU core")
    (ref_out, ref_grad), seconds = token_future.result()
    e_out = close(token_run[0], torch.from_numpy(ref_out))
    e_grad = close(token_run[1], torch.from_numpy(ref_grad))
    say(f"main: soft_trimmed_token_loss ({TOKENS},) card vs CPU port: value "
        f"{e_out:.3e}, gradients {e_grad:.3e} (tol 1e-5 * (1 + max|CPU|); "
        f"CPU {seconds:.1f} s)")
    engine_cpu_checks(engine_runs, engine_futures)
    experiments_cpu_checks(experiment_runs, experiment_futures)
    say(paper_claims(experiment_runs))
    say(f"kernels: waited {time.perf_counter() - t0:.1f} s for the CPU "
        "workers after phase 4")
    for kname in ("pav_l2", "pav_kl"):
      say(f"kernels: {kname} worst |kernel - plain divide and conquer| "
          f"{max_err[kname]:.3e}, worst |kernel - stack machine| "
          f"{max_err[kname + ' vs stack']:.3e} (both within 1e-5 * (1 + "
          "max|plain|))")
  finally:
    pool.shutdown(wait=True, cancel_futures=True)

  clock("the CPU workers")
  dryrun_dir = tempfile.mkdtemp(prefix="dryrun_")
  dryrun_procs = start_dryrun(dryrun_dir)
  # 5. times -------------------------------------------------------------------
  lines = []
  kernel_rows = {}
  plain_fns = {"pav_l2": pav_scan.pav_l2_scan, "pav_kl": pav_scan.pav_kl_scan}
  for rows, n in KERNEL_SHAPES:
    if rows == 1:
      s, w = main_solver_inputs(None, to_dev(tokens_np, dev))
      theta = to_dev(tokens_np.reshape(1, -1), dev)
    else:
      theta = to_dev(theta_np[(rows, n)], dev)
      s, w = main_solver_inputs(theta, None)
    _, (rs, rw) = solver_inputs(rng, rows, n, "random")
    rs, rw = to_dev(rs, dev), to_dev(rw, dev)
    ramps = to_dev(two_ramps(rows, n), dev)
    inputs = {("pav_l2", "main"): ((s - w).contiguous(),),
              ("pav_kl", "main"): (s, w),
              ("pav_l2", "random"): (rs - rw,),
              ("pav_kl", "random"): (rs, rw),
              ("pav_l2", "adversarial"): (ramps,),
              ("pav_kl", "adversarial"): (ramps, torch.zeros_like(ramps))}
    reps = 5 if rows == 1 else 20
    for (kname, kind), args in inputs.items():
      kernel = getattr(pav, kname)
      out = kernel(*args)
      blocks = int(segment_vjp.block_starts(out).sum())
      push, merge, block = OPS[kname]
      n_ops = rows * n * push + (rows * n - blocks) * merge + blocks * block
      bytes_ms = rows * n * BYTES_PER_ELEM[kname] / HBM_BYTES_PER_S * 1e3
      ops_ms = n_ops / F32_OPS_PER_S * 1e3
      bound_ms = max(bytes_ms, ops_ms)
      bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
      ms = median_ms(lambda: kernel(*args), reps)
      dev_text = ""
      if kind == "main":
        dev_ms = kernel_device_ms(lambda: kernel(*args), DEVICE_NAMES[kname],
                                  reps, bound_ms,
                                  pav.kernels_a_call(rows, n))
        dev_text = f" (device {ms_text(dev_ms)}, profiler)"
      plain_ms = None
      if kind == "main":
        plain = plain_fns[kname]
        plain_ms = median_ms(lambda: plain(*args), 1, warmup=0)
      if kind == "main":
        kernel_rows[(kname, (rows, n))] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}
      plain_text = ("not measured" if plain_ms is None
                    else f"{plain_ms:.1f} ms ({plain_fns[kname].__name__})")
      lines.append(f"times: {kname} ({rows}, {n}) {kind} input: kernel "
                   f"{ms:.4f} ms{dev_text}, plain {plain_text}, bound "
                   f"{bound_ms:.5f} ms"
                   f" ({bound_by}), {blocks} blocks [{name_limit}]")
    sort_ms = median_ms(
        lambda: torch.sort(theta, dim=-1, descending=True, stable=True), reps)
    lines.append(f"times: torch.sort ({rows}, {n}) {sort_ms:.4f} ms "
                 f"(yardstick, not on the kernel path) [{name_limit}]")

  ops = operators(rt)
  for shape in SHAPES:
    x = to_dev(theta_np[shape], dev).requires_grad_(True)
    t = to_dev(target_np[shape], dev)
    g = to_dev(cot_np[shape], dev)
    for opname in OPERATORS:
      op = ops[opname]
      with torch.no_grad():
        fwd = median_ms(lambda: op(x, t), 10)

      def fwd_bwd():
        out = op(x, t)
        torch.autograd.grad(out, x, g if out.dim() else None)

      both = median_ms(fwd_bwd, 10)
      lines.append(f"times: {opname} {shape} fwd {fwd:.4f} ms, fwd+bwd "
                   f"{both:.4f} ms [{name_limit}]")
  xt = to_dev(tokens_np, dev).requires_grad_(True)
  op = ops["soft_trimmed_token_loss"]
  with torch.no_grad():
    fwd = median_ms(lambda: op(xt, None), 5)
  both = median_ms(lambda: torch.autograd.grad(op(xt, None), xt), 5)
  lines.append(f"times: soft_trimmed_token_loss ({TOKENS},) fwd {fwd:.4f} ms,"
               f" fwd+bwd {both:.4f} ms [{name_limit}]")
  serve_rows, serve_lines = serve_times(serve_res, serve_rec, serve, st, fa,
                                        name_limit)
  engine_rows, engine_lines = engine_times(serve, pav, pav_scan, segment_vjp,
                                           dev, engine_rng, record,
                                           name_limit)
  from repro_torch.kernels import dispatch
  backward_lines = backward_times(pav, dispatch, dev, engine_rng, name_limit)
  option_lines, option_rows = attn_option_times(dev, fa, name_limit)
  simt_rows, simt_lines = simt_times(dev, fa, name_limit)
  for line in (lines + serve_lines + engine_lines + backward_lines
               + option_lines + simt_lines):
    say(line)

  clock("phase 5")
  # serve, dense ------------------------------------------------------------
  # The deepseek server's 27-layer model (30.2 GiB) goes first, so that the
  # dense server's peak memory is its own.
  del serve_res, serve_rec
  gc.collect()
  torch.cuda.empty_cache()
  say(f"serve: the {ARCH} server's model freed; "
      f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB still allocated")

  # Figure 4 ---------------------------------------------------------------
  for line in fig4_checks(rt, dev):
    say(line)
  for line in fig4_times(rt, dev, name_limit):
    say(line)
  clock("figure 4")
  # smoke configs and examples (f32: the CUDA-core attention kernel) -----
  _, smoke_counts = smoke_phase(dev, kops, name_limit)
  clock("smoke configs")
  dense_res, dense_launches, dense_rec, dense_err = dense_serve_path(
      dev, serve, kops, st, fa)
  for kname, err in dense_err.items():
    max_err[kname] = max(max_err[kname], err)
  dense_row, dense_lines = dense_serve_times(dense_res, dense_rec, serve, fa,
                                             name_limit)
  for line in dense_lines:
    say(line)
  del dense_res, dense_rec

  clock(f"serve {DENSE_ARCH}")
  gc.collect()
  torch.cuda.empty_cache()
  f32_launches, f32_row, f32_lines = dense_f32_serve(dev, serve, kops, st,
                                                     fa, name_limit)
  for line in f32_lines:
    say(line)
  clock(f"serve {DENSE_ARCH} f32")
  # serve, grok ---------------------------------------------------------------
  # Full width, 6 of 64 layers (58 GiB of weights): the card must be empty.
  gc.collect()
  torch.cuda.empty_cache()
  grok_res, grok_launches, grok_rec, grok_err = grok_serve_path(
      dev, serve, kops, st, fa)
  for kname, err in grok_err.items():
    max_err[kname] = max(max_err[kname], err)
  grok_row, grok_gate_rows, grok_lines = grok_serve_times(
      grok_res, grok_rec, serve, st, fa, name_limit)
  for line in grok_lines:
    say(line)
  del grok_res, grok_rec
  gc.collect()
  torch.cuda.empty_cache()
  decode_rows, decode_lines = decode_attn_times(dev, name_limit)
  for line in decode_lines:
    say(line)

  clock(f"serve {GROK_ARCH}")
  # serve, gemma, stablelm, recurrentgemma, xlstm and llava ---------------
  # Each at full width and depth (gemma 21.9 GiB of weights and 6.1 GiB of
  # caches), each model freed before the next.
  full_launches, full_rows = {}, {}
  for arch in FULL_SERVE_RUNS:
    gc.collect()
    torch.cuda.empty_cache()
    res, full_launches[arch], rec, err = full_serve_path(dev, serve, kops,
                                                         st, fa, arch)
    for kname, e in err.items():
      max_err[kname] = max(max_err[kname], e)
    full_rows[arch], full_lines = full_serve_times(res, rec, serve, fa, dev,
                                                   name_limit)
    for line in full_lines:
      say(line)
    del res, rec
    clock(f"serve {arch}")

  # serve, musicgen at the steps' level -------------------------------------
  gc.collect()
  torch.cuda.empty_cache()
  res, audio_launches, rec, err = audio_serve_path(dev, kops, st, fa)
  for kname, e in err.items():
    max_err[kname] = max(max_err[kname], e)
  audio_row, audio_lines = audio_serve_times(res, rec, fa, dev, name_limit)
  for line in audio_lines:
    say(line)
  del res, rec
  clock(f"serve {MUSICGEN_ARCH}")

  # 6. train ------------------------------------------------------------------
  # Each trainer's model and state go before the next one's.
  train_launches, train_rows, first_losses = {}, {}, {}
  for arch in TRAIN_RUNS:
    gc.collect()
    torch.cuda.empty_cache()
    say(f"train: {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB "
        f"allocated before {arch}'s trainer")
    train_res, train_rec, train_launches[arch] = train_path(dev, fa, arch)
    train_lines, captured = train_checks(train_rec, train_res["cfg"], fa, dev,
                                         arch)
    for line in train_lines:
      say(line)
    run = TRAIN_RUNS[arch]
    first_losses[arch] = train_rec.losses[:train_res["cfg"].grad_accum]
    if "same_losses_as" in run:
      say("train: " + same_losses_text(first_losses, arch,
                                       run["same_losses_as"]))
    if run.get("timed", True):
      time_lines, train_rows[arch] = train_times(
          train_res, train_rec, captured, fa, name_limit, arch)
    else:
      train_rows[arch], line = train_attn_times(captured, fa, name_limit,
                                                arch)
      time_lines = [line]
    for line in time_lines:
      say(line)
    del train_res, train_rec, captured
    clock(f"train {arch}")

  # mesh ------------------------------------------------------------------
  gc.collect()
  torch.cuda.empty_cache()
  from repro_torch.kernels import ops as kernel_ops
  mesh_lines, mesh_launches = mesh_phase(dev, kernel_ops, name_limit)
  for line in mesh_lines:
    say(line)
  for line in dryrun_lines(dryrun_procs, dryrun_dir):
    say(line)
  clock("mesh")

  # 7. summary -------------------------------------------------------------
  kernels = kernels_summary(
      launches=launches, max_err=max_err, kernel_rows=kernel_rows,
      serve_counts={ARCH: serve_launches, DENSE_ARCH: dense_launches,
                    GROK_ARCH: grok_launches, **full_launches,
                    MUSICGEN_ARCH: audio_launches},
      serve_rows=serve_rows, dense_row=dense_row, grok_row=grok_row,
      grok_gate_rows=grok_gate_rows, full_rows=full_rows,
      audio_row=audio_row,
      train_launches=train_launches, train_rows=train_rows,
      engine_runs=engine_runs, engine_rows=engine_rows,
      option_rows=option_rows, mesh_launches=mesh_launches,
      simt_rows=simt_rows, smoke_counts=smoke_counts,
      example_rows=example_rows, simt_serve=f32_row,
      experiment_runs=experiment_runs, decode_rows=decode_rows)
  say(json.dumps({"kernels": kernels}))
  say(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
