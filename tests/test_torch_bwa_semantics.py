"""The bwa-0.7.8 semantics tests/test_bwa_semantics.py pins, on the port's
copies (bwamem_tpu_torch/pipeline/align.py, pipeline/pair.py): each case
runs once on the port's modules and once on the JAX package's, through
one body that takes the package as an argument; the port's answer must
pass the reference test's checks and equal the reference's answer,
field for field."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import bwamem_tpu.config as ref_config
import bwamem_tpu.io.fasta as ref_fasta
import bwamem_tpu.ops.local_ref as ref_local_ref
import bwamem_tpu.pipeline.align as ref_align
import bwamem_tpu.pipeline.chain as ref_chain
import bwamem_tpu.pipeline.cigar as ref_cigar
import bwamem_tpu.pipeline.pair as ref_pair
import bwamem_tpu_torch.config as config
import bwamem_tpu_torch.io.fasta as fasta
import bwamem_tpu_torch.ops.local_ref as local_ref
import bwamem_tpu_torch.pipeline.align as align
import bwamem_tpu_torch.pipeline.chain as chain
import bwamem_tpu_torch.pipeline.cigar as cigar
import bwamem_tpu_torch.pipeline.pair as pair

from _torch_gate import plain

torch.set_num_threads(1)

PORT = SimpleNamespace(config=config, fasta=fasta, local_ref=local_ref,
                       align=align, chain=chain, cigar=cigar, pair=pair)
REF = SimpleNamespace(config=ref_config, fasta=ref_fasta,
                      local_ref=ref_local_ref, align=ref_align,
                      chain=ref_chain, cigar=ref_cigar, pair=ref_pair)


def both(body):
    """body(package) on the port, then on the reference: the port's
    answer, checked equal to the reference's."""
    got, want = body(PORT), body(REF)
    assert plain(got) == plain(want)
    return got


def R(m, rb, re, qb, qe, score, **kw):
    return m.align.Region(rb=rb, re=re, qb=qb, qe=qe, score=score, **kw)


def _dedup(regs):
    return both(lambda m: m.align.sort_and_dedup(
        m.config.MemOptions(), [R(m, *r) for r in regs]))


class TestSortAndDedup:
    def test_exact_duplicates_dropped(self):
        out = _dedup([(100, 200, 0, 100, 80), (100, 200, 0, 100, 80),
                      (300, 400, 0, 100, 70)])
        assert len(out) == 2

    def test_redundant_subregion_dropped(self):
        """A region whose reference span is >= 95% covered by a
        higher-scoring region is redundant (the MASK_LEVEL_REDUN
        reconstruction)."""
        out = _dedup([(100, 300, 0, 100, 90), (105, 300, 5, 100, 60)])
        assert len(out) == 1 and out[0].score == 90

    def test_low_overlap_kept(self):
        out = _dedup([(100, 300, 0, 100, 90), (250, 450, 0, 100, 60)])
        assert len(out) == 2

    def test_final_order_is_score_desc(self):
        """bwa ends with ks_introsort(mem_ars): a[0] must be the best
        hit (mem_pestat reads regs[i][0])."""
        out = _dedup([(500, 600, 0, 100, 40), (100, 200, 0, 100, 90),
                      (300, 400, 0, 100, 70)])
        assert [r.score for r in out] == [90, 70, 40]


class TestPestatConfidence:
    """mem_pestat's repeat filter is bwa's cal_sub: skip a pair when the
    best hit of either end has an overlapping competitor scoring more
    than MIN_RATIO (0.8) of it."""

    @staticmethod
    def _pestat(sub_score):
        def body(m):
            l_pac = 1 << 20
            pairs = []
            for i in range(20):
                rb1 = 1000 + 500 * i
                r1 = [R(m, rb1, rb1 + 100, 0, 100, 100)]
                if sub_score is not None:
                    r1.append(R(m, rb1 + 9000, rb1 + 9100, 0, 100,
                                sub_score))
                # mate on the reverse strand, FR orientation, isize ~300
                rb2 = (l_pac << 1) - (rb1 + 300)
                pairs.append((r1, [R(m, rb2, rb2 + 100, 0, 100, 100)]))
            return m.pair.infer_isize(m.config.MemOptions(), l_pac, pairs)
        return both(body)

    def test_unique_pairs_counted(self):
        assert any(not p.failed for p in self._pestat(None))

    def test_repetitive_pairs_excluded(self):
        assert PORT.pair.MIN_RATIO == REF.pair.MIN_RATIO == 0.8
        # 90 > 0.8 * 100 -> repeat
        assert all(p.failed for p in self._pestat(90))

    def test_weak_secondary_ok(self):
        # 50 < 0.8 * 100 -> confident
        assert any(not p.failed for p in self._pestat(50))

    def test_cal_sub_overlap_rule(self):
        opt = config.MemOptions()

        def body(m):
            o = m.config.MemOptions()
            return [m.pair.cal_sub(o, [R(m, 0, 100, 0, 100, 100),
                                       R(m, *second)])
                    for second in ((5000, 5100, 0, 100, 77),
                                   (5000, 5220, 60, 220, 77))]

        full, partial = both(body)
        assert full == 77  # full query overlap
        # overlap 40 < 0.5 * min_len 100: not significant -> the floor
        assert partial == opt.min_seed_len * opt.a


class TestMemPair:
    @staticmethod
    def _pes(m):
        pes = [m.pair.PEStat() for _ in range(4)]
        pes[1] = m.pair.PEStat(low=100, high=600, avg=300.0, std=30.0,
                               failed=False)
        return pes

    def test_n_sub_counts_against_final_best(self):
        def body(m):
            l_pac = 1 << 20
            # two read-1 candidates near each other, one mate: two pair
            # candidates with scores within tmp of each other
            r1 = [R(m, 1000, 1100, 0, 100, 100),
                  R(m, 1010, 1110, 0, 100, 98)]
            rb2 = (l_pac << 1) - 1300
            r2 = [R(m, rb2, rb2 + 100, 0, 100, 100)]
            return m.pair.mem_pair(m.config.MemOptions(), l_pac,
                                   self._pes(m), (r1, r2))

        score, sub, n_sub, n_raw, z = both(body)
        assert z is not None and score > 0
        assert n_raw == 2
        # tmp = max(a+b, o_del+e_del, o_ins+e_ins) = 7 at defaults;
        # the runner-up is within 7 of the best -> n_sub == 1
        assert n_sub == 1
        assert sub > 0  # second-best score, not -1

    def test_no_candidates(self):
        score, sub, n_sub, n_raw, z = both(lambda m: m.pair.mem_pair(
            m.config.MemOptions(), 1 << 20, [m.pair.PEStat()] * 4, ([], [])))
        assert (score, sub, n_sub, z) == (0, 0, 0, None)


class TestContainedSeedRightGap:
    def test_contained_seed_right_gap_uses_read_end(self):
        """PARITY.md Deviations #9: the right-hand query distance of the
        contained-seed skip measures to the END OF THE READ (bwa-0.7.8's
        own asymmetry), not to the covering region's qe."""
        def body(m):
            opt = m.config.MemOptions()
            # region covering [0, 80) with a band shrunk to 10; a
            # contained seed near its right edge
            p = m.align.Region(qb=0, qe=80, rb=100, re=180, w=10,
                               seedlen0=20)
            s = m.chain.Seed(rbeg=110, qbeg=60, len=18)  # qend 78, rend 128
            assert s.qend <= p.qe and s.rend <= p.re
            # a seed at BOTH right edges whose left distances differ by
            # exactly w (no left skip): the right test alone decides
            p2 = m.align.Region(qb=0, qe=80, rb=90, re=180, w=10,
                                seedlen0=20)
            s2 = m.chain.Seed(rbeg=160, qbeg=60, len=18)  # qend 78, rend 178
            return [m.align._seed_covered(opt, s, [p], l_query=150),
                    m.align._seed_covered(opt, s2, [p2], l_query=80),
                    m.align._seed_covered(opt, s2, [p2], l_query=150)]

        read_end, at_both_ends, longer_read = both(body)
        # read-end formula: 72 - 52 = 20 >= w=10 -> NOT covered
        assert read_end is False
        # read ends at the region: qd=2, rd=2 -> covered
        assert at_both_ends is True
        # same seed, longer read: qd=72, rd=2 -> the read-end formula
        # refuses the skip (a p.qe formula would skip)
        assert longer_read is False


class TestRescueThresholdAndSqueeze:
    @pytest.mark.parametrize("score,accepted", [(30, False), (40, True)])
    def test_matesw_threshold_scales_with_a(self, monkeypatch, score,
                                            accepted):
        """PARITY.md Deviations #7: the rescue acceptance threshold is
        min_seed_len * a (frozen scaled form): with a=2, 30 < 19*2 is
        rejected (an unscaled reading would accept it, 30 >= 19) and
        40 >= 38 accepted."""
        def fake_align(seq, rseq, mat, od, ed, oi, ei):
            return (score, 0, len(seq), 0, len(seq), 0)

        def body(m):
            monkeypatch.setattr(m.local_ref, "ksw_align", fake_align)
            rng = np.random.default_rng(0)
            pac = rng.integers(0, 4, 200).astype(np.uint8)
            ref = m.fasta.Reference(contigs=[m.fasta.Contig("c", 0, 200)],
                                    pac=pac)
            pes = [m.pair.PEStat(low=1, high=40, avg=20.0, std=5.0,
                                 failed=False) for _ in range(4)]
            anchor = m.align.Region(rb=50, re=80, qb=0, qe=30, score=60)
            regs = []
            n = m.pair.mem_matesw(m.config.MemOptions(a=2), ref, pes, anchor,
                                  pac[90:120].astype(np.int64), regs)
            return n, regs

        n, regs = both(body)
        if accepted:
            assert n >= 1 and len(regs) >= 1
        else:
            assert n == 0 and regs == []

    def test_reg2aln_deletion_squeeze_else_if(self):
        """PARITY.md Deviations #8: a leading OR a trailing deletion is
        squeezed, never both (bwa mem_reg2aln's else-if)."""
        def body(m):
            rng = np.random.default_rng(1)
            pac = rng.integers(0, 4, 60).astype(np.uint8)
            ref = m.fasta.Reference(contigs=[m.fasta.Contig("c", 0, 60)],
                                    pac=pac)
            opt = m.config.MemOptions()
            ar = m.align.Region(qb=0, qe=5, rb=9, re=16, score=10, truesc=10,
                                w=opt.w, secondary=-1)
            # a band-forced [1D, 5M, 1D] global result
            D, M = m.cigar.D_OP, m.cigar.M_OP
            return m.align.reg2aln(opt, ref, pac[10:15].astype(np.int64), ar,
                                   global_result=(6, [(D, 1), (M, 5),
                                                      (D, 1)]))

        aln = both(body)
        # the leading D is absorbed into pos; the trailing D SURVIVES
        assert aln.cigar[0][0] == cigar.M_OP
        assert aln.cigar[-1] == (cigar.D_OP, 1), aln.cigar
