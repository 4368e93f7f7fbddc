"""CoNLL-2005 SRL readers (reference python/paddle/dataset/conll05.py:76
corpus_reader — the same words/props gz pair inside the test tarball,
the same bracket→IOB label expansion, and reader_creator's predicate
context-window feature construction)."""
import gzip
import tarfile
import warnings

from . import common

__all__ = ["get_dict", "test", "corpus_reader", "reader_creator",
           "load_dict", "load_label_dict"]

DATA_URL = ("http://paddlemodels.bj.bcebos.com/conll05st/"
            "conll05st-tests.tar.gz")
WORDDICT_URL = ("http://paddlemodels.bj.bcebos.com/conll05st%2F"
                "wordDict.txt")
VERBDICT_URL = ("http://paddlemodels.bj.bcebos.com/conll05st%2F"
                "verbDict.txt")
TRGDICT_URL = ("http://paddlemodels.bj.bcebos.com/conll05st%2F"
               "targetDict.txt")

UNK_IDX = 0


def load_label_dict(filename):
    """B-/I- pairs per bracket tag + O, same ordering as the
    reference."""
    d = {}
    tag_dict = set()
    with open(filename, "r") as f:
        for line in f:
            line = line.strip()
            if line.startswith("B-"):
                tag_dict.add(line[2:])
            elif line.startswith("I-"):
                tag_dict.add(line[2:])
    index = 0
    for tag in sorted(tag_dict):
        d["B-" + tag] = index
        index += 1
        d["I-" + tag] = index
        index += 1
    d["O"] = index
    return d


def load_dict(filename):
    d = {}
    with open(filename, "r") as f:
        for i, line in enumerate(f):
            d[line.strip()] = i
    return d


def _expand_labels(labels):
    """The reference's bracket walk: '(A0*' opens tag A0, '*)' closes,
    bare '*' continues — emitted as B-/I-/O sequences per predicate."""
    verb_list = []
    for x in labels[0]:
        if x != "-":
            verb_list.append(x)
    out = []
    for i, lbl in enumerate(labels[1:]):
        cur_tag = "O"
        is_in_bracket = False
        lbl_seq = []
        for token in lbl:
            if token == "*" and not is_in_bracket:
                lbl_seq.append("O")
            elif token == "*" and is_in_bracket:
                lbl_seq.append("I-" + cur_tag)
            elif token == "*)":
                lbl_seq.append("I-" + cur_tag)
                is_in_bracket = False
            elif "(" in token and ")" in token:
                cur_tag = token[1:token.find("*")]
                lbl_seq.append("B-" + cur_tag)
                is_in_bracket = False
            elif "(" in token and ")" not in token:
                cur_tag = token[1:token.find("*")]
                lbl_seq.append("B-" + cur_tag)
                is_in_bracket = True
            else:
                raise RuntimeError(f"Unexpected label: {token}")
        out.append((verb_list[i], lbl_seq))
    return out


def corpus_reader(data_path, words_name, props_name):
    """Yields (sentence words, predicate, IOB label sequence) triples
    from the words/props gz members of the tarball — the reference's
    sentence segmentation (blank props line ends a sentence)."""

    def reader():
        tf = tarfile.open(data_path)
        wf = tf.extractfile(words_name)
        pf = tf.extractfile(props_name)
        with gzip.GzipFile(fileobj=wf) as words_file, \
                gzip.GzipFile(fileobj=pf) as props_file:
            sentences = []
            labels = []
            one_seg = []
            for word, label in zip(words_file, props_file):
                word = word.strip().decode()
                label = label.strip().decode().split()
                if len(label) == 0:   # end of sentence
                    for i in range(len(one_seg[0])):
                        labels.append([x[i] for x in one_seg])
                    if len(labels) >= 1:
                        for verb, lbl_seq in _expand_labels(labels):
                            yield sentences, verb, lbl_seq
                    sentences = []
                    labels = []
                    one_seg = []
                else:
                    sentences.append(word)
                    one_seg.append(label)
        pf.close()
        wf.close()
        tf.close()

    return reader


def reader_creator(corpus_rdr, word_dict=None, predicate_dict=None,
                   label_dict=None):
    """The reference's feature construction: word ids, 5-word predicate
    context window (replicated over the sentence), predicate region
    mark, predicate id, label ids."""

    def reader():
        for sentence, predicate, labels in corpus_rdr():
            sen_len = len(sentence)
            verb_index = labels.index("B-V")
            mark = [0] * len(labels)
            if verb_index > 0:
                mark[verb_index - 1] = 1
                ctx_n1 = sentence[verb_index - 1]
            else:
                ctx_n1 = "bos"
            if verb_index > 1:
                mark[verb_index - 2] = 1
                ctx_n2 = sentence[verb_index - 2]
            else:
                ctx_n2 = "bos"
            mark[verb_index] = 1
            ctx_0 = sentence[verb_index]
            if verb_index < len(labels) - 1:
                mark[verb_index + 1] = 1
                ctx_p1 = sentence[verb_index + 1]
            else:
                ctx_p1 = "eos"
            if verb_index < len(labels) - 2:
                mark[verb_index + 2] = 1
                ctx_p2 = sentence[verb_index + 2]
            else:
                ctx_p2 = "eos"

            word_idx = [word_dict.get(w, UNK_IDX) for w in sentence]
            ctx = [[word_dict.get(c, UNK_IDX)] * sen_len
                   for c in (ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2)]
            pred_idx = [predicate_dict.get(predicate)] * sen_len
            label_idx = [label_dict.get(w) for w in labels]
            yield (word_idx, ctx[0], ctx[1], ctx[2], ctx[3], ctx[4],
                   pred_idx, mark, label_idx)

    return reader


def get_dict():
    try:
        word_dict = load_dict(
            common.download(WORDDICT_URL, "conll05st",
                            save_name="wordDict.txt"))
        verb_dict = load_dict(
            common.download(VERBDICT_URL, "conll05st",
                            save_name="verbDict.txt"))
        label_dict = load_label_dict(
            common.download(TRGDICT_URL, "conll05st",
                            save_name="targetDict.txt"))
        return word_dict, verb_dict, label_dict
    except common.DatasetNotDownloaded as e:
        warnings.warn(f"conll05.get_dict: {e}; synthetic fallback")
        from .synthetic import conll05 as syn
        return syn.get_dict()


def test():
    try:
        path = common.download(DATA_URL, "conll05st")
        words_name = "conll05st-release/test.wsj/words/test.wsj.words.gz"
        props_name = "conll05st-release/test.wsj/props/test.wsj.props.gz"
        word_dict, verb_dict, label_dict = get_dict()
        return reader_creator(
            corpus_reader(path, words_name, props_name),
            word_dict, verb_dict, label_dict)
    except common.DatasetNotDownloaded as e:
        warnings.warn(f"conll05.test: {e}; synthetic fallback")
        from .synthetic import conll05 as syn
        return syn.test()
