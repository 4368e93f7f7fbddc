"""analysis/suppress.py — the shared lint-suppression grammar.

racecheck, numcheck, and protocheck all parse suppressions through
this one module; these are the grammar's own edge cases (the
analyzer test files only exercise the happy path): comment blocks,
multiple tags sharing a line, the reason-less downgrade to
``bad-suppression``, multi-rule lists, and the two match modes
(line-anchored vs file-scoped).
"""
import textwrap

from paddle_tpu_torch.analysis.suppress import Suppressions


def parse(src, tag="protocheck"):
    return Suppressions(textwrap.dedent(src), "snippet.py", tag=tag)


def test_trailing_same_line_form():
    s = parse("""
        x = 1
        y = do_thing()  # protocheck: ok(counter-dead) — scraped out of band
    """)
    assert s.match(3, "counter-dead") == "scraped out of band"
    assert 3 in s.used
    assert not s.bad


def test_comment_line_attaches_to_next_code_line():
    s = parse("""
        # protocheck: ok(verb-dead) — operator probe
        y = do_thing()
    """)
    # matches via the comment's own line (line above the finding)...
    assert s.match(3, "verb-dead") == "operator probe"
    # ...and via the code line it attached to
    assert 3 in s.by_line


def test_multiline_comment_block_attaches_past_the_block():
    s = parse("""
        # protocheck: ok(verb-asymmetric) — socket-only by design: a
        # pipe replica is a child process on the same host and shares
        # the parent's filesystem
        elif_line = serve()
    """)
    assert s.match(5, "verb-asymmetric") is not None
    # the intermediate comment lines carry nothing
    assert 3 not in s.by_line and 4 not in s.by_line


def test_multiple_rules_one_comment():
    s = parse("""
        z = 1  # protocheck: ok(counter-dead, knob-undocumented) — both fine
    """)
    assert s.match(2, "counter-dead") == "both fine"
    assert s.match(2, "knob-undocumented") == "both fine"
    assert s.match(2, "verb-dead") is None


def test_all_wildcard():
    s = parse("""
        z = 1  # protocheck: ok(all) — generated file, vendored verbatim
    """)
    assert s.match(2, "anything-at-all") is not None


def test_reasonless_is_downgraded_to_bad_suppression():
    s = parse("""
        z = 1  # protocheck: ok(counter-dead)
    """)
    assert s.match(2, "counter-dead") is None     # does NOT suppress
    assert [d.code for d in s.bad] == ["bad-suppression"]
    assert s.bad[0].line == 2


def test_empty_rule_list_is_bad():
    s = parse("""
        z = 1  # protocheck: ok() — a reason without any rule
    """)
    assert s.match(2, "counter-dead") is None
    assert [d.code for d in s.bad] == ["bad-suppression"]


def test_two_tags_share_a_line_each_parser_sees_its_own():
    src = """
        z = 1  # racecheck: ok(global-mutation) — r1 # protocheck: ok(verb-dead) — r2
    """
    proto = parse(src, tag="protocheck")
    race = parse(src, tag="racecheck")
    assert proto.match(2, "verb-dead") == "r2"
    assert proto.match(2, "global-mutation") is None
    assert race.match(2, "global-mutation") is not None
    assert race.match(2, "verb-dead") is None


def test_wrong_tag_is_invisible():
    s = parse("""
        z = 1  # numcheck: ok(counter-dead) — wrong analyzer's tag
    """)
    assert s.match(2, "counter-dead") is None
    assert not s.bad        # not malformed, just not ours


def test_dash_styles_for_the_reason():
    for sep in ("—", "-", "–", ":"):
        s = parse(f"""
            z = 1  # protocheck: ok(verb-dead) {sep} the reason
        """)
        assert s.match(2, "verb-dead") == "the reason", sep


def test_match_is_line_anchored_not_file_scoped():
    s = parse("""
        z = 1  # protocheck: ok(counter-dead) — only this line
        a = 2
        b = 3
    """)
    assert s.match(2, "counter-dead") is not None
    assert s.match(4, "counter-dead") is None


def test_match_any_is_file_scoped():
    s = parse("""
        z = 1
        a = 2  # protocheck: ok(fp16-overflow-risk) — bounded by sigmoid
        b = 3
    """)
    assert s.match_any("fp16-overflow-risk") == "bounded by sigmoid"
    assert s.match_any("int8-scale-clip") is None


def test_used_tracks_matched_lines():
    s = parse("""
        z = 1  # protocheck: ok(verb-dead) — matched
        a = 2  # protocheck: ok(counter-dead) — never matched
    """)
    assert s.used == set()
    s.match(2, "verb-dead")
    assert s.used == {2}


def test_suppression_on_blank_line_does_not_attach_forward():
    # a comment block separated from code by a blank line attaches to
    # nothing beyond its own lines (the block-walk stops at blank)
    s = parse("""
        # protocheck: ok(verb-dead) — floating comment

        y = do_thing()
    """)
    assert s.match(4, "verb-dead") is None
