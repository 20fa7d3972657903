"""Chat web UI, the gradio_demo frontend replacement (counterpart of
seed_tpu/serving/webui.py: the same static page).

One self-contained HTML page, feature-matched to the reference Gradio
frontend (gradio_demo/seed_llama_gradio.py):

- multi-turn chat with image upload against the stateless /generate
  endpoint; the conversation template (USER:/ASSISTANT:, '\\n'
  separator) is rendered client-side exactly like
  Conversation.get_prompt, and returned image-id caches are reused so
  every uploaded image is encoded once (conversation.py update_image_ids
  semantics);
- client-side image guards before upload: longest side resized to 512
  (resize_image :101-112) and center-crop to aspect ratio <= 1.5
  (center_crop_image :116-137) on a canvas;
- regenerate flow (:163-170): drop the last assistant turn, resubmit the
  same user state;
- up/down vote buttons posting {type, state} to /vote (:139-160 —
  server-side daily JSON-lines log, server.py record_vote);
- sampling controls (temperature / top-p / max new tokens) and
  force-image-generation, the gradio sliders + force_img_gen checkbox;
- send/regenerate disabled while a request is in flight (disable_btn
  semantics).
"""

PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>SEED-LLaMA (seed_tpu_torch)</title>
<style>
 body{font-family:system-ui,sans-serif;max-width:780px;margin:24px auto;padding:0 12px}
 #log{border:1px solid #ccc;border-radius:8px;padding:12px;min-height:300px}
 .turn{margin:8px 0}.role{font-weight:600}
 .turn img{max-width:256px;display:block;margin:4px 0;border-radius:6px}
 #bar,#opts{display:flex;gap:8px;margin-top:12px;align-items:center;flex-wrap:wrap}
 #msg{flex:1;padding:8px}
 .err{color:#b00}
 #opts label{font-size:13px;color:#444}
 #opts input[type=number]{width:64px}
 button:disabled{opacity:.5}
 #votes button{font-size:16px}
</style></head><body>
<h2>SEED-LLaMA &mdash; PyTorch / CUDA</h2>
<div id="log"></div>
<div id="bar">
 <input id="msg" placeholder="Message&hellip; (attach an image below)"/>
 <input id="img" type="file" accept="image/*"/>
 <button id="sendbtn" onclick="send()">Send</button>
 <button id="regenbtn" onclick="regenerate()" disabled>&#x1F504; Regenerate</button>
 <button onclick="reset()">Clear</button>
 <span id="votes">
  <button id="upbtn" onclick="vote('upvote')" disabled>&#x1F44D;</button>
  <button id="downbtn" onclick="vote('downvote')" disabled>&#x1F44E;</button>
 </span>
</div>
<div id="opts">
 <label><input id="forceimg" type="checkbox"/> force image generation</label>
 <label>temperature <input id="temp" type="number" step="0.1" min="0" max="2" value="0.7"/></label>
 <label>top-p <input id="topp" type="number" step="0.05" min="0" max="1" value="0.5"/></label>
 <label>max new tokens <input id="maxnew" type="number" min="1" max="1024" value="256"/></label>
</div>
<script>
const SEP = "\\n";
let turns = [];           // {role, text, images:[b64|ids], ids:[...]}
let pending = false;
function esc(s){const d=document.createElement('div');d.innerText=s;return d.innerHTML}
function setButtons(){
  document.getElementById('sendbtn').disabled = pending;
  const hasReply = turns.length && turns[turns.length-1].role==='ASSISTANT';
  for(const id of ['regenbtn','upbtn','downbtn'])
    document.getElementById(id).disabled = pending || !hasReply;
}
function render(){
  const log=document.getElementById('log'); log.innerHTML='';
  for(const t of turns){
    const div=document.createElement('div'); div.className='turn';
    let html='<span class="role">'+esc(t.role)+':</span> ';
    let parts=t.text.split('<image>');
    for(let i=0;i<parts.length;i++){
      html+=esc(parts[i]);
      if(i<t.images.length){
        const im=t.images[i];
        if(typeof im==='string'&&im.length>64)
          html+='<img src="data:image/png;base64,'+im+'"/>';
        else html+='<em>[image]</em>';
      }
    }
    if(t.error) html+='<div class="err">'+esc(t.error)+'</div>';
    div.innerHTML=html; log.appendChild(div);
  }
  log.scrollTop=log.scrollHeight;
  setButtons();
}
function prompt_body(){
  let text=''; let images=[];
  for(const t of turns){
    text+=t.role+': '+t.text+SEP;
    for(let i=0;i<t.images.length;i++)
      images.push(t.ids&&t.ids[i]?t.ids[i]:t.images[i]);
  }
  text+='ASSISTANT:';
  return {text, images};
}
// image guards of the reference frontend: longest side -> 512
// (resize_image) then center-crop to aspect <= 1.5 (center_crop_image)
async function guardImage(file){
  const img = await new Promise((res,rej)=>{
    const i=new Image(); i.onload=()=>res(i); i.onerror=rej;
    i.src=URL.createObjectURL(file);});
  let w=img.width, h=img.height;
  const MAXAR=1.5, ar=Math.max(w,h)/Math.min(w,h);
  let sx=0, sy=0, sw=w, sh=h;
  if(ar>=MAXAR){
    if(w>h){ sw=Math.floor(h*MAXAR); sx=Math.floor((w-sw)/2); }
    else   { sh=Math.floor(w*MAXAR); sy=Math.floor((h-sh)/2); }
  }
  const MAX=512; let ow, oh;
  if(sw>sh){ ow=Math.min(MAX,sw); oh=Math.round(ow*sh/sw); }
  else     { oh=Math.min(MAX,sh); ow=Math.round(oh*sw/sh); }
  const cv=document.createElement('canvas'); cv.width=ow; cv.height=oh;
  cv.getContext('2d').drawImage(img, sx, sy, sw, sh, 0, 0, ow, oh);
  return cv.toDataURL('image/png').split(',')[1];
}
async function submitState(){
  pending=true; setButtons();
  const body=prompt_body();
  body.force_boi=document.getElementById('forceimg').checked;
  body.max_new_tokens=parseInt(document.getElementById('maxnew').value)||256;
  body.top_p=parseFloat(document.getElementById('topp').value)||0.5;
  body.temperature=parseFloat(document.getElementById('temp').value)||0.7;
  try{
    const r=await fetch('/generate',{method:'POST',
      headers:{'Content-Type':'application/json'},body:JSON.stringify(body)});
    const j=await r.json();
    // back-fill id caches for prompt images, in order
    let k=0;
    for(const t of turns){ t.ids=t.ids||[];
      for(let i=0;i<t.images.length;i++){
        if(k<j.images_ids.length&&j.images_ids[k]) t.ids[i]=j.images_ids[k];
        k++; } }
    turns.push({role:'ASSISTANT', text:j.text, images:j.images,
                error:(j.error_msg||[]).join('; ')});
  }catch(e){
    turns.push({role:'ASSISTANT', text:'', images:[], error:String(e)});
  }
  pending=false; render();
}
async function send(){
  if(pending) return;
  const msgEl=document.getElementById('msg');
  const fileEl=document.getElementById('img');
  let text=msgEl.value||''; let images=[];
  if(fileEl.files.length){
    images.push(await guardImage(fileEl.files[0]));
    text+=' <image>';
  }
  turns.push({role:'USER', text, images}); render();
  msgEl.value=''; fileEl.value='';
  await submitState();
}
async function regenerate(){
  if(pending||!turns.length) return;
  if(turns[turns.length-1].role==='ASSISTANT') turns.pop();
  render();
  await submitState();
}
async function vote(type){
  if(pending) return;
  try{
    await fetch('/vote',{method:'POST',
      headers:{'Content-Type':'application/json'},
      body:JSON.stringify({type, state:{turns: turns.map(
        t=>({role:t.role, text:t.text, ids:t.ids||[]}))}})});
  }catch(e){}
  document.getElementById('upbtn').disabled=true;
  document.getElementById('downbtn').disabled=true;
}
function reset(){turns=[];render();}
document.getElementById('msg').addEventListener('keydown',
  e=>{if(e.key==='Enter')send();});
render();
</script></body></html>
"""
