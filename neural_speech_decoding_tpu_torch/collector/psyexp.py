"""PsychoPy Builder `.psyexp` ingestion.

Own copy of neural_speech_decoding_tpu/collector/psyexp.py.
The reference ships its experiment definition as Builder XML
(reference: DataCollectionExperiment.psyexp:101-190): a SoundComponent
beep (0-0.5 s), a `$words` TextComponent cue (0.5 s + 4 s), a literal
"COOL OFF" TextComponent (4.5 s + 1.5 s), and a fullRandom loop whose
conditions are both inline (OrderedDict reprs) and in `words.csv`. Round 3
reproduced that schedule as a hand-written ExperimentConfig; this module
closes the loop by PARSING an existing .psyexp back into one, so a lab's
edited Builder file (different timings, different vocabulary) drives the
headless collector without transcription.

Only the stdlib XML parser is used; nothing here imports PsychoPy.
"""

from __future__ import annotations

import ast
import re
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Dict, List, Tuple

from neural_speech_decoding_tpu_torch.collector.experiment import ExperimentConfig


def _params(component: ET.Element) -> Dict[str, str]:
    return {
        p.get("name"): p.get("val")
        for p in component.findall("Param")
        if p.get("name") is not None
    }


def _float(params: Dict[str, str], key: str, default: float) -> float:
    raw = (params.get(key) or "").strip()
    try:
        return float(raw)
    except ValueError:
        return default


def _start_dur(
    params: Dict[str, str], default_start: float, default_dur: float
) -> Tuple[float, float]:
    """(onset, duration) of a component, honoring Builder's stopType:
    'duration (s)' stopVals ARE durations; 'time (s)' stopVals are
    absolute routine-relative end times (duration = stop - start). Other
    stopTypes ('condition', frame counts) are not timing-recoverable and
    keep the default duration."""
    start = _float(params, "startVal", default_start)
    stop_type = (params.get("stopType") or "duration (s)").strip()
    raw = (params.get("stopVal") or "").strip()
    try:
        stop_val = float(raw)
    except ValueError:
        return start, default_dur
    if stop_type == "time (s)":
        return start, max(0.0, stop_val - start)
    if stop_type == "duration (s)":
        return start, stop_val
    return start, default_dur


def _trial_routine_names(root: ET.Element) -> Tuple[str, ...]:
    """Names of the routines the trials loop repeats: the Flow entries
    between the first isTrials LoopInitiator and its matching
    LoopTerminator. Components elsewhere (welcome/instruction/feedback
    routines) must not contribute timings."""
    flow = root.find("Flow")
    if flow is None:
        return ()
    names: List[str] = []
    in_loop = None
    for el in flow:
        if el.tag == "LoopInitiator":
            p = _params(el)
            if in_loop is None and p.get("isTrials") != "False":
                in_loop = el.get("name") or (p.get("name") or "").strip()
        elif el.tag == "LoopTerminator":
            if in_loop is not None and (el.get("name") or "") == in_loop:
                break
        elif el.tag == "Routine" and in_loop is not None:
            name = el.get("name")
            if name:
                names.append(name)
    return tuple(names)


def _loop_words(loop_params: Dict[str, str], psyexp_path: Path) -> Tuple[str, ...]:
    """Conditions from the sibling conditions file when it exists, else
    from the inline `conditions` repr (a list of OrderedDict reprs — the
    reference's words.csv is absent from its snapshot, so the inline copy
    is the recoverable source, SURVEY.md intro)."""
    cond_file = (loop_params.get("conditionsFile") or "").strip()
    if cond_file:
        cand = psyexp_path.parent / cond_file
        if cand.is_file():
            from neural_speech_decoding_tpu_torch.collector.experiment import (
                load_words_csv,
            )

            try:
                return tuple(load_words_csv(cand))
            except ValueError:
                pass  # non-words conditions file; fall through to inline
    inline = loop_params.get("conditions") or ""
    words: List[str] = []
    # the val is a repr like "[OrderedDict([('words', 'water'), ...]), ...]"
    for match in re.finditer(r"OrderedDict\((\[.*?\])\)", inline):
        try:
            pairs = dict(ast.literal_eval(match.group(1)))
        except (ValueError, SyntaxError):
            continue
        if "words" in pairs:
            words.append(str(pairs["words"]))
    return tuple(words)


def load_psyexp(path) -> ExperimentConfig:
    """Parse a Builder .psyexp into the headless collector's
    ExperimentConfig: beep/word/cool-off timings from the trial routine's
    components, vocabulary + nReps from the trial loop.

    Identification is structural, not name-based: the beep is the first
    SoundComponent; the cue word is the TextComponent whose text is a
    `$variable`; the cool-off is the latest-starting literal
    TextComponent. Values missing from the XML keep ExperimentConfig
    defaults. Note the reference quirk: its Builder file says nReps=1 and
    the generated script overrides it with the string "10"
    (reference: Neural_decoding_data_collector.py:15,476) — this parser
    reports what the XML says; pass n_reps explicitly to reproduce a
    specific session length.
    """
    path = Path(path)
    root = ET.parse(path).getroot()

    beep = ExperimentConfig.beep_seconds
    word = ExperimentConfig.word_seconds
    cool = ExperimentConfig.cooloff_seconds
    word_start = None

    # scan ONLY the routines the trials loop repeats — a welcome routine's
    # attention beep or a feedback routine's $msg text must not hijack the
    # trial timings (timings are routine-relative, so cross-routine
    # comparison would be meaningless anyway)
    routine_defs = root.find("Routines")
    trial_names = _trial_routine_names(root)
    if routine_defs is not None and trial_names:
        scan: List[ET.Element] = [
            r for r in routine_defs if r.get("name") in trial_names
        ]
    else:
        scan = [root]  # degenerate XML: fall back to a whole-document scan

    found_beep = False
    literal_texts = []
    for routine in scan:
        for sound in routine.iter("SoundComponent"):
            p = _params(sound)
            if p.get("disabled") == "True" or found_beep:
                continue
            start, dur = _start_dur(p, 0.0, beep)
            beep = start + dur  # beep phase ends when the sound ends
            found_beep = True
        for text in routine.iter("TextComponent"):
            p = _params(text)
            if p.get("disabled") == "True":
                continue
            content = (p.get("text") or "").strip()
            if content.startswith("$") and word_start is None:
                word_start, word = _start_dur(p, beep, word)
            elif not content.startswith("$"):
                literal_texts.append(p)
    if literal_texts:
        # cool-off = the literal text that starts last in the routine
        p = max(literal_texts, key=lambda q: _float(q, "startVal", 0.0))
        _, cool = _start_dur(p, 0.0, cool)

    n_reps = ExperimentConfig.n_reps
    seed = ExperimentConfig.seed
    words: Tuple[str, ...] = ()
    for loop in root.iter("LoopInitiator"):
        p = _params(loop)
        if p.get("isTrials") == "False":
            continue
        try:
            n_reps = int(float(p.get("nReps") or n_reps))
        except ValueError:
            pass
        try:
            seed = int(float(p.get("random seed") or seed))
        except ValueError:
            pass
        words = _loop_words(p, path) or words
        break

    if word_start is not None and abs(word_start - beep) > 1e-9:
        # schedule with a gap between beep end and word onset: fold the
        # gap into the beep phase so trial_seconds stays faithful
        beep = word_start

    kwargs = dict(beep_seconds=beep, word_seconds=word, cooloff_seconds=cool,
                  n_reps=n_reps, seed=seed)
    if words:
        kwargs["words"] = words
    return ExperimentConfig(**kwargs)
