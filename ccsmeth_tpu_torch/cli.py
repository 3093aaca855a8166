"""ccsmeth-tpu-torch CLI: the eight subcommands of ``ccsmeth_tpu/cli.py``,
``call_hifi``, ``call_mods``, ``align_hifi``, ``call_freqt``, ``call_freqb``,
``extract``, ``train`` and ``trainm`` (flags mirror ``cli.py:309-323``,
``:324-391``, ``:394-408``, ``:410-492``, ``:238-294`` and ``:500-520``) plus
``--device`` where a model runs.

Usage:
    python -m ccsmeth_tpu_torch.cli call_mods -i reads.bam -o out -m model.npz \\
        --mode align --ref ref.fa [--device cuda|cpu] [--precision fp32|bf16] \\
        [--model_type attbilstm2s|attbigru2s2|attbilstm2s2|transencoder2s] \\
        [--rnn_backend pallas_layer] [--h0_mode randn] \\
        [--num_processes N --process_id k] [--profile_dir DIR]
    python -m ccsmeth_tpu_torch.cli extract -i reads.bam -o features.tsv \\
        --mode align --ref ref.fa
    python -m ccsmeth_tpu_torch.cli call_mods -i features.tsv -o out \\
        -m model.npz [--device cuda|cpu]
    python -m ccsmeth_tpu_torch.cli call_freqb -i out.modbam.bam --ref ref.fa \\
        -o freq [--call_mode aggregate -m aggr.npz --device cuda|cpu] \\
        [--num_processes N --process_id k [--dist_coordinator host:port]]
    python -m ccsmeth_tpu_torch.cli call_freqt -i out.per_readsite.tsv \\
        -o freq.txt
    python -m ccsmeth_tpu_torch.cli train --train_file train.tsv \\
        --valid_file valid.tsv --model_dir models [--device cuda|cpu] \\
        [--precision fp32|bf16] [--train_transfer fp32|bf16|packed] \\
        [--model_type attbilstm2s|attbigru2s2|attbilstm2s2|transencoder2s]
    python -m ccsmeth_tpu_torch.cli trainm ... [--model_type attbigru1s|attbilstm1s] \\
        [--num_processes N --process_id k --dist_coordinator host:port]
    python -m ccsmeth_tpu_torch.cli call_hifi -i subreads.bam [-o hifi.bam]
    python -m ccsmeth_tpu_torch.cli align_hifi -i hifi.bam --ref ref.fa \\
        [--minimap2 | --bwa]
"""

from __future__ import annotations

import argparse
import sys

from ._version import __version__
from .utils.process import display_args, str2bool


def _add_extraction_args(p, call_mods=False):
    g = p.add_argument_group("EXTRACTION")
    g.add_argument("--mode", type=str, default="denovo", choices=["denovo", "align"],
                   help="denovo: without reference position info; align: with. "
                        "default denovo")
    g.add_argument("--holeids_e", type=str, default=None,
                   help="file contains holeids to be extracted, default None")
    g.add_argument("--holeids_ne", type=str, default=None,
                   help="file contains holeids not to be extracted, default None")
    if not call_mods:
        g.add_argument("--seq_len", type=int, default=21, help="len of kmer. default 21")
    g.add_argument("--motifs", type=str, default="CG",
                   help="motif seq to be extracted, default CG; comma-separated, IUPAC ok")
    g.add_argument("--mod_loc", type=int, default=0,
                   help="0-based location of the targeted base in the motif, default 0")
    g.add_argument("--methy_label", type=int, choices=[1, 0], default=1,
                   help="label of the interested modified bases (training), default 1")
    g.add_argument("--norm", type=str, default="zscore",
                   choices=["zscore", "min-mean", "min-max", "mad", "none"],
                   help="normalization method for ipd/pw, default zscore")
    g.add_argument("--no_decode", action="store_true", default=False,
                   help="do not use CodecV1 to decode ipd/pw")
    g.add_argument("--holes_batch", type=int, default=50,
                   help="number of reads per batch, default 50")
    if not call_mods:
        g.add_argument("--is_sn", type=str, default="no",
                       help="if extracting signal-to-noise features, yes or no, default no")
        g.add_argument("--is_map", type=str, default="no",
                       help="if extracting mapping features, yes or no, default no")
    ga = p.add_argument_group("EXTRACTION ALIGN_MODE")
    ga.add_argument("--ref", type=str, default=None,
                    help="path to genome reference (fasta), required in align mode")
    ga.add_argument("--mapq", type=int, default=1, help="MAPQ cutoff, default 1")
    ga.add_argument("--identity", type=float, default=0.0,
                    help="identity cutoff [0.0-1.0], default 0.0")
    ga.add_argument("--no_supplementary", action="store_true", default=False,
                    help="not use supplementary alignment")
    ga.add_argument("--skip_unmapped", type=str, default="yes",
                    help="if skipping unmapped sites in reads, yes or no, default yes")
    p.add_argument("--path_to_samtools", type=str, default=None,
                   help=argparse.SUPPRESS)


# the --model_type choices of call_mods and train; trainm adds the
# single-strand families (ccsmeth_tpu/cli.py:509-515)
MODEL_TYPES = ("attbilstm2s", "attbigru2s", "transencoder2s", "attbilstm2s2",
               "attbigru2s2")
MODEL_TYPES_TRAINM = MODEL_TYPES + ("attbigru1s", "attbilstm1s")


def _add_model_args(p, train=False, model_types=MODEL_TYPES):
    g = p.add_argument_group("MODEL_HYPER")
    g.add_argument("--model_type", type=str, default="attbigru2s",
                   choices=list(model_types),
                   help="model type, default attbigru2s")
    g.add_argument("--seq_len", type=int, default=21, help="len of kmer, default 21")
    g.add_argument("--is_npass", type=str, default="yes",
                   help="if using num_pass features, yes or no, default yes")
    g.add_argument("--is_stds", type=str, default="no",
                   help="if using std features, yes or no, default no")
    g.add_argument("--is_sn", type=str, default="no",
                   help="if using signal-to-noise features, yes or no, default no")
    g.add_argument("--is_map", type=str, default="no",
                   help="if using mapping features, yes or no, default no")
    g.add_argument("--class_num", type=int, default=2)
    g.add_argument("--dropout_rate", type=float, default=0.5 if train else 0)
    gr = p.add_argument_group("MODEL_HYPER RNN")
    gr.add_argument("--layer_rnn", type=int, default=3, help="BiRNN layer num, default 3")
    gr.add_argument("--hid_rnn", type=int, default=256, help="BiRNN hidden size, default 256")
    gt = p.add_argument_group("MODEL_HYPER TRANSFORMER")
    gt.add_argument("--layer_trans", type=int, default=6)
    gt.add_argument("--nhead", type=int, default=4)
    gt.add_argument("--d_model", type=int, default=256)
    gt.add_argument("--dim_ff", type=int, default=512)


def main_call_mods(args):
    from .pipeline.call_mods import CallModsConfig, call_mods_bam, call_mods_txt

    display_args(args)
    cfg = CallModsConfig(
        model_file=args.model_file, model_type=args.model_type, seq_len=args.seq_len,
        is_npass=str2bool(args.is_npass), is_stds=str2bool(args.is_stds),
        is_sn=str2bool(args.is_sn), is_map=str2bool(args.is_map),
        class_num=args.class_num, dropout_rate=args.dropout_rate,
        batch_size=args.batch_size, layer_rnn=args.layer_rnn, hid_rnn=args.hid_rnn,
        layer_trans=args.layer_trans, nhead=args.nhead, d_model=args.d_model,
        dim_ff=args.dim_ff, holes_batch=args.holes_batch, keep_pulse=args.keep_pulse,
        no_sort=args.no_sort, threads=args.threads, mode=args.mode, ref=args.ref,
        motifs=args.motifs, mod_loc=args.mod_loc, methy_label=args.methy_label,
        norm=args.norm, no_decode=args.no_decode, mapq=args.mapq,
        identity=args.identity, no_supplementary=args.no_supplementary,
        skip_unmapped=str2bool(args.skip_unmapped), holeids_e=args.holeids_e,
        holeids_ne=args.holeids_ne, gzip_out=args.gzip,
        rnn_backend=args.rnn_backend, precision=args.precision,
        dispatch_fuse=args.dispatch_fuse, sort_mem_mb=args.sort_mem_mb,
        transfer_quant=args.transfer_quant, fetch_quant=args.fetch_quant,
        profile_dir=args.profile_dir, h0_mode=args.h0_mode, tseed=args.tseed,
        num_processes=args.num_processes, process_id=args.process_id,
        device=args.device)
    if args.input.endswith(".bam") or args.input.endswith(".sam"):
        if args.seq_len % 2 == 0:
            raise ValueError("--seq_len must be odd")
        call_mods_bam(cfg, args.input, args.output)
    else:
        call_mods_txt(cfg, args.input, args.output)


def main_extract(args):
    from .pipeline.extract import extract_hifireads_features

    display_args(args)
    extract_hifireads_features(args)


def main_call_freqt(args):
    from .pipeline.call_freq_txt import FreqTxtConfig, call_mods_frequency_to_file

    display_args(args)
    call_mods_frequency_to_file(FreqTxtConfig(
        input_path=args.input_path, result_file=args.result_file,
        file_uid=args.file_uid, contigs=args.contigs, threads=args.threads,
        bed=args.bed, sort=args.sort, prob_cf=args.prob_cf,
        rm_1strand=args.rm_1strand, gzip=args.gzip,
        refsites_only=args.refsites_only, motifs=args.motifs, mod_loc=args.mod_loc,
        ref=args.ref))


def main_call_freqb(args):
    from .pipeline.call_freq_bam import (FreqBamConfig,
                                         call_mods_frequency_from_bamfile)

    display_args(args)
    call_mods_frequency_from_bamfile(FreqBamConfig(
        input_bam=args.input_bam, ref=args.ref, output=args.output,
        contigs=args.contigs, chunk_len=args.chunk_len, modtype=args.modtype,
        call_mode=args.call_mode, prob_cf=args.prob_cf, no_amb_cov=args.no_amb_cov,
        hap_tag=args.hap_tag, mapq=args.mapq, identity=args.identity,
        no_supplementary=args.no_supplementary, motifs=args.motifs,
        mod_loc=args.mod_loc, no_comb=args.no_comb,
        refsites_only=args.refsites_only, refsites_all=args.refsites_all,
        no_hap=args.no_hap, base_clip=args.base_clip, aggre_model=args.aggre_model,
        model_type=args.model_type, seq_len=args.seq_len, class_num=args.class_num,
        layer_rnn=args.layer_rnn, hid_rnn=args.hid_rnn, bin_size=args.bin_size,
        cov_cf=args.cov_cf, only_close=args.only_close, discrete=args.discrete,
        tseed=args.tseed, bed=args.bed, sort=args.sort, gzip=args.gzip,
        threads=args.threads, num_processes=args.num_processes,
        process_id=args.process_id, dist_coordinator=args.dist_coordinator,
        device=args.device))


def main_call_hifi(args):
    from .wrappers.call_hifi import CallHifiConfig, ccs_call_hifi_reads

    display_args(args)
    ccs_call_hifi_reads(CallHifiConfig(
        subreads=args.subreads, output=args.output, path_to_ccs=args.path_to_ccs,
        threads=args.threads, min_passes=args.min_passes, by_strand=args.by_strand,
        hd_finder=args.hd_finder, log_level=args.log_level,
        path_to_samtools=args.path_to_samtools))


def main_align_hifi(args):
    from .wrappers.align_hifi import AlignHifiConfig, align_hifi_reads_to_genome

    display_args(args)
    align_hifi_reads_to_genome(AlignHifiConfig(
        hifireads=args.hifireads, ref=args.ref, output=args.output,
        path_to_pbmm2=args.path_to_pbmm2, minimap2=args.minimap2,
        path_to_minimap2=args.path_to_minimap2, bestn=args.bestn, bwa=args.bwa,
        path_to_bwa=args.path_to_bwa, path_to_samtools=args.path_to_samtools,
        threads=args.threads))


def main_train(args):
    """``train`` and ``trainm``: one process, or with ``trainm
    --num_processes N --process_id k --dist_coordinator host:port`` rank k
    of N (one a card)."""
    from .training import TrainConfig, train

    display_args(args)
    train(TrainConfig(
        train_file=args.train_file, valid_file=args.valid_file,
        model_dir=args.model_dir, model_type=args.model_type, seq_len=args.seq_len,
        is_npass=str2bool(args.is_npass), is_sn=str2bool(args.is_sn),
        is_map=str2bool(args.is_map), is_stds=str2bool(args.is_stds),
        class_num=args.class_num, dropout_rate=args.dropout_rate,
        layer_rnn=args.layer_rnn, hid_rnn=args.hid_rnn,
        layer_trans=args.layer_trans, nhead=args.nhead, d_model=args.d_model,
        dim_ff=args.dim_ff, optim_type=args.optim_type, batch_size=args.batch_size,
        lr_scheduler=args.lr_scheduler, lr=args.lr, lr_decay=args.lr_decay,
        lr_decay_step=args.lr_decay_step, lr_patience=args.lr_patience,
        lr_mode_strategy=args.lr_mode_strategy, max_epoch_num=args.max_epoch_num,
        min_epoch_num=args.min_epoch_num, pos_weight=args.pos_weight,
        step_interval=args.step_interval, init_model=args.init_model,
        step_fuse=args.step_fuse, dl_offsets=args.dl_offsets,
        train_transfer=args.train_transfer,
        save_opt_state=args.save_opt_state, resume_from=args.resume_from,
        rnn_backend=args.rnn_backend, precision=args.precision,
        tseed=args.tseed, device=args.device,
        dist_coordinator=getattr(args, "dist_coordinator", None),
        num_processes=getattr(args, "num_processes", 1),
        process_id=getattr(args, "process_id", 0)))


def _add_train_args(p, model_types=MODEL_TYPES):
    gi = p.add_argument_group("INPUT")
    gi.add_argument("--train_file", type=str, required=True)
    gi.add_argument("--valid_file", type=str, required=True)
    go = p.add_argument_group("OUTPUT")
    go.add_argument("--model_dir", type=str, required=True)
    _add_model_args(p, train=True, model_types=model_types)
    g = p.add_argument_group("TRAINING")
    g.add_argument("--optim_type", type=str, default="Adam",
                   choices=["Adam", "RMSprop", "SGD", "Ranger", "LookaheadAdam"])
    g.add_argument("--batch_size", type=int, default=512)
    g.add_argument("--lr_scheduler", type=str, default="StepLR",
                   choices=["StepLR", "ReduceLROnPlateau"])
    g.add_argument("--lr", type=float, default=0.001)
    g.add_argument("--lr_decay", type=float, default=0.1)
    g.add_argument("--lr_decay_step", type=int, default=1)
    g.add_argument("--lr_patience", type=int, default=0)
    g.add_argument("--lr_mode_strategy", type=str, default="last",
                   choices=["last", "mean", "max"])
    g.add_argument("--max_epoch_num", type=int, default=50)
    g.add_argument("--min_epoch_num", type=int, default=10)
    g.add_argument("--pos_weight", type=float, default=1.0)
    g.add_argument("--step_interval", type=int, default=500)
    g.add_argument("--step_fuse", type=int, default=8,
                   help="batches per host->device copy between logging "
                        "boundaries, run as that many steps in turn; "
                        "1 = one copy per step")
    g.add_argument("--dl_num_workers", type=int, default=0,
                   help="[IGNORED] data loading is vectorized in-process")
    g.add_argument("--dl_offsets", action="store_true", default=False,
                   help="stream training data out-of-core (chunked windowed "
                        "shuffle) instead of loading it all in RAM")
    g.add_argument("--init_model", type=str, default=None)
    g.add_argument("--rnn_backend", type=str, default="xla",
                   choices=["xla", "pallas"],
                   help="kept for flag parity: on cuda every value trains the "
                        "BiRNN through the hand-written kernels, on cpu "
                        "through their plain PyTorch versions")
    g.add_argument("--precision", type=str, default="fp32",
                   choices=["fp32", "bf16"],
                   help="operand type of the BiRNN's or the encoder's "
                        "products (f32 accumulation), default fp32")
    g.add_argument("--train_transfer", type=str, default="fp32",
                   choices=["fp32", "bf16", "packed"],
                   help="wire format of the train batch: fp32 (exact), bf16 "
                        "columns (features round to ~3 decimal digits; "
                        "labels/mask exact) or packed quantized byte rows "
                        "(kmer/npass/labels/mask exact, kinetics round to "
                        "1/16), unpacked on the device")
    g.add_argument("--use_compile", type=str, default="no",
                   help="[IGNORED] reference-CLI compatibility")
    g.add_argument("--save_opt_state", action="store_true", default=False,
                   help="persist optimizer state + epoch next to each checkpoint")
    g.add_argument("--resume_from", type=str, default=None,
                   help="params .ckpt.npz to resume from (restores optimizer "
                        "state + epoch when its .train_state.npz, written by "
                        "this package, exists)")
    g.add_argument("--tseed", type=int, default=1234)
    g.add_argument("--device", type=str, default="cuda",
                   help="cuda[:i] (default) or cpu; cuda without a GPU raises. "
                        "A rank of trainm --num_processes N takes cuda:i as "
                        "given, or for cuda card process_id modulo the cards")


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="ccsmeth-tpu-torch",
        description="detecting DNA methylation from PacBio CCS reads — "
                    "PyTorch + CUDA port of ccsmeth-tpu")
    parser.add_argument("-v", "--version", action="version",
                        version="ccsmeth-tpu-torch {}".format(__version__))
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("call_hifi", help="generate hifi reads with kinetics from "
                                         "subreads.bam using CCS")
    p.add_argument("--subreads", "-i", type=str, required=True,
                   help="path to subreads.bam file as input")
    p.add_argument("--output", "-o", type=str, default=None,
                   help="output file path, bam/sam; default input_prefix.hifi.bam")
    p.add_argument("--path_to_ccs", type=str, default=None)
    p.add_argument("--threads", "-t", type=int, default=None)
    p.add_argument("--min-passes", dest="min_passes", type=int, default=None)
    p.add_argument("--by-strand", dest="by_strand", action="store_true", default=False)
    p.add_argument("--hd-finder", dest="hd_finder", action="store_true", default=False)
    p.add_argument("--log-level", dest="log_level", type=str, default="WARN")
    p.add_argument("--path_to_samtools", type=str, default=None)
    p.set_defaults(func=main_call_hifi)

    p = sub.add_parser("call_mods", help="call modifications")
    gi = p.add_argument_group("INPUT")
    gi.add_argument("--input", "-i", type=str, required=True,
                    help="input file: bam/sam, or features.tsv from extract")
    go = p.add_argument_group("OUTPUT")
    go.add_argument("--output", "-o", type=str, required=True,
                    help="output prefix ([out].per_readsite.tsv / [out].modbam.bam)")
    go.add_argument("--gzip", action="store_true", default=False)
    go.add_argument("--keep_pulse", action="store_true", default=False)
    go.add_argument("--no_sort", action="store_true", default=False)
    gc = p.add_argument_group("CALL")
    gc.add_argument("--model_file", "-m", type=str, required=True,
                    help="trained model (.ckpt torch or .npz native)")
    _add_model_args(p)
    gc.add_argument("--batch_size", "-b", type=int, default=512)
    gc.add_argument("--device", type=str, default="cuda",
                    help="cuda (default: every visible card, one model "
                         "replica a card, each batch split among them), "
                         "cuda:i (that card) or cpu; cuda without a GPU raises")
    gc.add_argument("--rnn_backend", type=str, default="xla",
                    choices=["xla", "pallas", "pallas_layer"],
                    help="RNN models: pallas_layer runs the BiRNN one "
                         "hand-written kernel launch per layer (K2), xla and "
                         "pallas the whole stack in one (K1); transencoder2s "
                         "runs its encoder kernel (K3) for every value; on "
                         "cpu the plain PyTorch versions")
    gc.add_argument("--use_compile", type=str, default="no",
                    help="[IGNORED] reference-CLI compatibility")
    gc.add_argument("--precision", type=str, default="fp32",
                    choices=["fp32", "bf16"],
                    help="operand type of the BiRNN or encoder (f32 "
                         "accumulation), default fp32")
    gc.add_argument("--sort_mem_mb", type=int, default=512,
                    help="memory budget for the output-modbam external merge "
                         "sort, default 512")
    gc.add_argument("--dispatch_fuse", type=int, default=8,
                    help="batches grouped per dispatch_many call, default 8")
    gc.add_argument("--transfer_quant", type=str, default="auto",
                    choices=["auto", "none", "int8"],
                    help="int8-quantize IPD/PW means for the host->device copy "
                         "(zscore/mad norms). auto = int8 on bf16, none on fp32")
    gc.add_argument("--fetch_quant", type=str, default="auto",
                    choices=["auto", "u8", "none"],
                    help="u8 fetches floor(p*256) ML bytes from the device. "
                         "auto = u8 on bf16, exact probs on fp32")
    gc.add_argument("--profile_dir", type=str, default=None,
                    help="write a torch.profiler trace (host, and the card on "
                         "cuda) of the dispatch loop here, as a Chrome trace")
    gc.add_argument("--h0_mode", type=str, default="zeros",
                    choices=["zeros", "randn"],
                    help="RNN initial state: zeros (deterministic default) or "
                         "randn (replays the reference's per-forward randn h0 "
                         "draws seeded by --tseed; requires --rnn_backend xla "
                         "and one process; the BiRNN then runs in plain "
                         "PyTorch, f32)")
    gs = p.add_argument_group("SCALE-OUT")
    gs.add_argument("--num_processes", type=int, default=1,
                    help="share-nothing scale-out: total processes splitting the "
                         "read stream by stable qname hash; run one call_mods "
                         "per process with a distinct -o, then merge the outputs")
    gs.add_argument("--process_id", type=int, default=0,
                    help="this process's rank in [0, num_processes)")
    _add_extraction_args(p, call_mods=True)
    p.add_argument("--threads", "-p", type=int, default=10)
    p.add_argument("--threads_call", type=int, default=3,
                   help="[compat] advisory only")
    p.add_argument("--tseed", type=int, default=1234)
    p.set_defaults(func=main_call_mods)

    p = sub.add_parser("align_hifi", help="align hifi reads to genome")
    p.add_argument("--hifireads", "-i", type=str, required=True)
    p.add_argument("--ref", type=str, required=True)
    p.add_argument("--output", "-o", type=str, default=None)
    p.add_argument("--header", action="store_true", default=False)
    p.add_argument("--path_to_pbmm2", type=str, default=None)
    p.add_argument("--minimap2", action="store_true", default=False)
    p.add_argument("--path_to_minimap2", type=str, default=None)
    p.add_argument("--bestn", "-n", type=int, default=3)
    p.add_argument("--bwa", action="store_true", default=False)
    p.add_argument("--path_to_bwa", type=str, default=None)
    p.add_argument("--path_to_samtools", type=str, default=None)
    p.add_argument("--threads", "-t", type=int, default=5)
    p.set_defaults(func=main_align_hifi)

    p = sub.add_parser("call_freqt", help="call frequency of modifications from "
                                          "per_readsite text files")
    p.add_argument("--input_path", "-i", action="append", type=str, required=True)
    p.add_argument("--file_uid", type=str, default=None)
    p.add_argument("--result_file", "-o", type=str, required=True)
    p.add_argument("--contigs", type=str, default=None)
    p.add_argument("--threads", type=int, default=1)
    p.add_argument("--bed", action="store_true", default=False)
    p.add_argument("--sort", action="store_true", default=False)
    p.add_argument("--prob_cf", type=float, default=0.0)
    p.add_argument("--rm_1strand", action="store_true", default=False)
    p.add_argument("--gzip", action="store_true", default=False)
    p.add_argument("--refsites_only", action="store_true", default=False)
    p.add_argument("--motifs", type=str, default="CG")
    p.add_argument("--mod_loc", type=int, default=0)
    p.add_argument("--ref", type=str, default=None)
    p.set_defaults(func=main_call_freqt)

    p = sub.add_parser("call_freqb", help="call frequency of modifications from "
                                          "modbam files")
    p.add_argument("--threads", type=int, default=5)
    p.add_argument("--input_bam", "-i", type=str, required=True)
    p.add_argument("--ref", type=str, required=True)
    p.add_argument("--contigs", type=str, default=None)
    p.add_argument("--chunk_len", type=int, default=500000)
    p.add_argument("--output", "-o", type=str, required=True)
    p.add_argument("--bed", action="store_true", default=False)
    p.add_argument("--sort", action="store_true", default=False)
    p.add_argument("--gzip", action="store_true", default=False)
    p.add_argument("--modtype", type=str, default="5mC", choices=["5mC"])
    p.add_argument("--call_mode", type=str, default="count",
                   choices=["count", "aggregate"])
    p.add_argument("--prob_cf", type=float, default=0.0)
    p.add_argument("--no_amb_cov", action="store_true", default=False)
    p.add_argument("--hap_tag", type=str, default="HP")
    p.add_argument("--mapq", type=int, default=1)
    p.add_argument("--identity", type=float, default=0.0)
    p.add_argument("--no_supplementary", action="store_true", default=False)
    p.add_argument("--motifs", type=str, default="CG")
    p.add_argument("--mod_loc", type=int, default=0)
    p.add_argument("--no_comb", action="store_true", default=False)
    p.add_argument("--refsites_only", action="store_true", default=False)
    p.add_argument("--refsites_all", action="store_true", default=False)
    p.add_argument("--no_hap", action="store_true", default=False)
    p.add_argument("--base_clip", type=int, default=0)
    p.add_argument("--aggre_model", "-m", type=str, default=None)
    p.add_argument("--model_type", type=str, default="attbigru",
                   choices=["attbilstm", "attbigru"])
    p.add_argument("--seq_len", type=int, default=11)
    p.add_argument("--class_num", type=int, default=1)
    p.add_argument("--layer_rnn", type=int, default=1)
    p.add_argument("--hid_rnn", type=int, default=32)
    p.add_argument("--bin_size", type=int, default=20)
    p.add_argument("--cov_cf", type=int, default=4)
    p.add_argument("--only_close", action="store_true", default=False)
    p.add_argument("--discrete", action="store_true", default=False)
    p.add_argument("--tseed", type=int, default=1234)
    p.add_argument("--device", type=str, default="cuda",
                   help="where the aggregate model runs: cuda[:i] (default; "
                        "its BiRNN through the hand-written kernel) or cpu "
                        "(the plain PyTorch version); cuda without a GPU "
                        "raises. Count mode runs on the host only")
    gp = p.add_argument_group("SCALE-OUT")
    gp.add_argument("--num_processes", type=int, default=1,
                    help="scale-out process count. Without --dist_coordinator: "
                         "share-nothing, each process owns a slice of the "
                         "genome chunk list; run one call_freqb per process "
                         "with a distinct -o, then concatenate. With it: the "
                         "collective merge")
    gp.add_argument("--process_id", type=int, default=0,
                    help="this process's rank in [0, num_processes)")
    gp.add_argument("--dist_coordinator", type=str, default=None,
                    help="host:port of rank 0 for a torch.distributed group: "
                         "the ranks split the reads by qname hash, all-reduce "
                         "the per-site counts (and histograms) of each chunk, "
                         "and rank 0 alone runs the aggregate model and "
                         "writes the output")
    p.set_defaults(func=main_call_freqb)

    p = sub.add_parser("extract", help="extract features from hifi reads")
    p.add_argument("--input", "-i", type=str, required=True,
                   help="input file in bam/sam format")
    p.add_argument("--output", "-o", type=str, default=None,
                   help="output features file; default input_prefix.features.tsv")
    p.add_argument("--gzip", action="store_true", default=False)
    _add_extraction_args(p)
    p.add_argument("--threads", type=int, default=5)
    p.set_defaults(func=main_extract)

    p = sub.add_parser("train", help="train a model")
    _add_train_args(p)
    p.set_defaults(func=main_train)

    p = sub.add_parser("trainm", help="train a model, also the single-strand "
                                      "families, in one process or one a card")
    _add_train_args(p, MODEL_TYPES_TRAINM)
    g = p.add_argument_group("DISTRIBUTED")
    g.add_argument("--dist_coordinator", type=str, default=None,
                   help="host:port of rank 0 for torch.distributed (rank 0 "
                        "serves it); needed with --num_processes > 1")
    g.add_argument("--num_processes", type=int, default=1,
                   help="total processes, one a card (ranks host-major; "
                        "with --device cuda rank k takes card k modulo the "
                        "host's cards); the global batch is batch_size x N")
    g.add_argument("--process_id", type=int, default=0,
                   help="this process's rank in [0, num_processes)")
    g.add_argument("--epoch_sync", action="store_true", default=False,
                   help="[compat] every rank applies the same summed "
                        "gradients every step; no-op")
    p.set_defaults(func=main_train)
    return parser


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)
    args.func(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
