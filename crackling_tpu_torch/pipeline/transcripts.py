"""Transcript-hit counting post-processor (``countHitTranscripts``).

Counts, for each accepted guide, how many of its gene's transcripts it
targets (guide start inside an exon). Semantics of
/root/reference/src/crackling/utils/countHitTranscripts.py:45-243 including
the pickle cache of the parsed GFF3, the ``seqId`` dot->underscore mangling,
the m/n output format, and the built-in sample fixture.
"""

from __future__ import annotations

import csv
import os
import pickle
import tempfile


def load_annotation(annotation_file: str, force_reload: bool = False):
    """Parse a GFF3 into exon interval maps (pickle-cached).

    Returns (annot, gene_data, gene_to_mrna, seq_to_gene, gene_to_seq,
    mrna_to_gene) with the same shapes as the reference
    (countHitTranscripts.py:45-146)."""
    annot: dict = {}
    gene_data: dict = {}
    gene_to_mrna: dict = {}
    seq_to_gene: dict = {}
    gene_to_seq: dict = {}
    mrna_to_gene: dict = {}

    pickled = f"{annotation_file}.p"
    if os.path.exists(pickled) and not force_reload:
        try:
            # reuse the parsed annotation unless the GFF changed since the
            # cache was written (reference reuse: countHitTranscripts.py:62-71)
            if os.path.getmtime(pickled) >= os.path.getmtime(annotation_file):
                with open(pickled, "rb") as fp:
                    return tuple(pickle.load(fp))
        except Exception:
            pass

    with open(annotation_file) as fp:
        for raw in fp:
            parts = [x.strip() for x in raw.split("\t")]
            if len(parts) != 9:
                continue
            seq_id, _source, ftype, start, end, _score, strand, _phase = parts[:8]
            seq_id = seq_id.replace(".", "_")
            try:
                attributes = dict(a.split("=", 1) for a in parts[8].split(";") if "=" in a)
            except ValueError:
                continue
            # both ID and Parent required — note this skips top-level gene
            # rows (they have no Parent), exactly like the reference
            # (countHitTranscripts.py:103-105)
            if "ID" not in attributes or "Parent" not in attributes:
                continue
            if ftype not in ("gene", "mRNA", "exon"):
                continue
            annot.setdefault(seq_id, {})
            if ftype == "gene":
                gene_data.setdefault(attributes["ID"], {
                    "seqId": seq_id, "start": start, "end": end, "strand": strand,
                })
                seq_to_gene.setdefault(seq_id, []).append(attributes["ID"])
                gene_to_seq.setdefault(attributes["ID"], []).append(seq_id)
            elif ftype == "mRNA":
                annot[seq_id].setdefault(attributes["ID"], [])
                gene_to_mrna.setdefault(attributes["Parent"], []).append(attributes["ID"])
                mrna_to_gene.setdefault(attributes["ID"], attributes["Parent"])
            elif ftype == "exon":
                annot[seq_id].setdefault(attributes["Parent"], []).append(
                    (int(start), int(end))
                )

    data = [annot, gene_data, gene_to_mrna, seq_to_gene, gene_to_seq, mrna_to_gene]
    with open(pickled, "wb") as fp:
        pickle.dump(data, fp)
    return tuple(data)


def count_transcripts(annot, gene_data, gene_to_mrna, seq_to_gene,
                      gene_to_seq, mrna_to_gene,
                      query_seq_id, query_start, query_end):
    """[hit transcripts, total transcripts of the gene]
    (reference countHitTranscripts.py:148-193)."""
    in_mrna = []
    if query_seq_id in annot:
        for mrna, exons in annot[query_seq_id].items():
            for e_start, e_end in exons:
                if e_start <= query_start <= e_end:
                    in_mrna.append(mrna)
                    break
    if not in_mrna:
        return [0, 0]
    genes = {mrna_to_gene[m] for m in in_mrna if m in mrna_to_gene}
    if len(genes) > 1:
        raise RuntimeError("Mapped to multiple genes - logical error?")
    gene = mrna_to_gene[in_mrna[0]]
    return [len(in_mrna), len(gene_to_mrna[gene])]


def process(gff_path: str, crackling_path: str):
    """Append an m/n ``hits`` column to a Crackling results CSV
    (reference countHitTranscripts.py:197-243)."""
    maps = load_annotation(gff_path, force_reload=False)
    results = []
    with open(crackling_path) as fp:
        reader = csv.reader(fp, delimiter=",", quotechar='"')
        idx = {}
        for line_num, line in enumerate(reader):
            if line_num == 0:
                idx = {k: line.index(k)
                       for k in ("seq", "bowtieChr", "bowtieStart", "bowtieEnd")}
                line.append("hits")
            else:
                if line[idx["bowtieChr"]] != "?":
                    try:
                        count = count_transcripts(
                            *maps,
                            line[idx["bowtieChr"]],
                            int(line[idx["bowtieStart"]]),
                            int(line[idx["bowtieEnd"]]),
                        )
                    except Exception:
                        count = ["?", "?"]
                else:
                    count = ["?", "?"]
                line.append(f"{count[0]}/{count[1]}")
            results.append(line)
    return results


SAMPLE_CRACKLING = """seq,bowtieChr,bowtieStart,bowtieEnd
AAAA,Chr1,60,83
AAAT,Chr1,200,223
AATA,Chr1,320,343
ATAA,Chr1,460,483
"""

SAMPLE_ANNOTATION = """Chr1	JakeSeq	gene	5	540	.	-	.	ID=gene1
Chr1	JakeSeq	mRNA	10	530	.	-	.	ID=rna1;Parent=gene1
Chr1	JakeSeq	exon	40	100	.	-	.	ID=exon1;Parent=rna1
Chr1	JakeSeq	exon	170	220	.	-	.	ID=exon2;Parent=rna1
Chr1	JakeSeq	exon	300	360	.	-	.	ID=exon3;Parent=rna1
Chr1	JakeSeq	mRNA	50	533	.	-	.	ID=rna2;Parent=gene1
Chr1	JakeSeq	exon	40	100	.	-	.	ID=exon4;Parent=rna2
Chr1	JakeSeq	exon	300	360	.	-	.	ID=exon5;Parent=rna2
Chr1	JakeSeq	mRNA	47	530	.	-	.	ID=rna3;Parent=gene1
Chr1	JakeSeq	exon	170	220	.	-	.	ID=exon6;Parent=rna3
Chr1	JakeSeq	exon	300	360	.	-	.	ID=exon7;Parent=rna3
Chr1	JakeSeq	mRNA	47	530	.	-	.	ID=rna4;Parent=gene1
Chr1	JakeSeq	exon	300	360	.	-	.	ID=exon8;Parent=rna4
"""

# Expected sample results (reference countHitTranscripts.py:277-281):
# AAAA 2/4, AAAT 2/4, AATA 4/4, ATAA 0/0
SAMPLE_EXPECTED = {"AAAA": "2/4", "AAAT": "2/4", "AATA": "4/4", "ATAA": "0/0"}


def use_sample_data():
    c = tempfile.NamedTemporaryFile(mode="w", suffix=".csv", delete=False)
    a = tempfile.NamedTemporaryFile(mode="w", suffix=".gff", delete=False)
    c.write(SAMPLE_CRACKLING)
    a.write(SAMPLE_ANNOTATION)
    c.close()
    a.close()
    return a.name, c.name


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("-a", "--annotation", default=None)
    parser.add_argument("-c", "--crackling", default=None)
    parser.add_argument("-o", "--output", default=None)
    parser.add_argument("-s", "--sample", action="store_true")
    args = parser.parse_args(argv)

    if args.sample:
        for row in process(*use_sample_data()):
            print(row)
        return
    results = process(args.annotation, args.crackling)
    with open(args.output, "w", newline="") as fp:
        w = csv.writer(fp, delimiter=",", quotechar='"',
                       dialect="unix", quoting=csv.QUOTE_MINIMAL)
        for row in results:
            w.writerow(row)
